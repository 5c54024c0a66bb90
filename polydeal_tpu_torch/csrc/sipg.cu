// SIPG assembly blocks for Hopper (sm_90a): the volume stiffness (K3),
// interior face group (K4) and boundary Nitsche (K5) blocks of the banded
// SIPG matrix, per polytope lane, over the slot-padded tables of
// polydeal_tpu_torch/assembly/sipg.py build_banded_groups.
//
// Replaces the TPU Pallas kernels of polydeal_tpu/ops/sipg_kernels.py:
//   K3  _volume_impl      (volume_blocks_pallas)
//   K4  _face_group_impl  (face_group_blocks_pallas)
//   K5  _boundary_impl    (boundary_blocks_pallas)
//
// Tables (entity-last, lane p = polytope, row-major, all of one type T):
//   pts, n [C, Q, DIM, P]; w [C, Q, P]; h_f [C, P]; ext, lo [DIM, P].
// Padded slots carry pts = 0.5, w = 0 and h_f = 1, so they add exact zeros;
// no slot is skipped by testing its weight, and nothing divides by one.
// A lane's N = C * Q quadrature points are n = c * Q + q.
//   K3  out[i*nb + j, p] = sum_n w * sum_d dphi_i/dx_d * dphi_j/dx_d
//   K5  out[i*nb + j, p] = sum_n w * (-phi_i dnphi_j - dnphi_i phi_j
//                                     + gamma phi_i phi_j)
//   K4  out[k, i*nb + j, p] for k = m11, m12, m21, m22 (reference
//       poly_utils.h:1870-1926): with beta = [phi0; -phi1] the signed
//       traces of both sides (side 0 is polytope p, side 1 its neighbour
//       p + offset) and g = [dnphi0; dnphi1], the four blocks are the one
//       symmetric 2nb x 2nb matrix
//         M = sum_n w * (-1/2 (g beta^T + beta g^T) + gamma beta beta^T),
//       m11 = M[0:nb, 0:nb], m12 = M[0:nb, nb:], m21 = m12^T, m22 = M[nb:,
//       nb:].
// gamma = penalty / h_f.  K4's side-1 unit points are the side-0 physical
// points pulled back into the box of lane (p + offset) mod P: the wrap of
// torch.roll, so wrapped lanes stay finite and vanish against zero weights.
// phi is the orthonormal Legendre P_p basis of fem/basis.py, evaluated in
// registers from the unit points: the graded exponent table is a
// compile-time constant, so every (i, d) loop unrolls, and gradients are
// scaled by 1/extent.  Built for dim 2-3 at p = 1-3, and K5 alone also in
// 2D at p = 4-5 (nb = 15, 21; q = 5, 6 points a boundary face slot), the
// shapes at which the JAX package's rule (polydeal_tpu/assembly/sipg.py
// assemble_sipg_banded_direct) gives its Pallas K5 the boundary blocks
// while the volume and face blocks (q = 25, 36 a cell) go to XLA: there
// the einsums of ops/sipg_kernels.py compute K3's and K4's blocks.
//
// Symmetric accumulation.  Every form is a symmetric M x M matrix (M = nb
// for K3 and K5, 2 nb for K4) summed over points, so a lane accumulates only
// its E = M (M + 1) / 2 upper-triangle entries (a <= b) and writes each to
// both of its places at the end: 10 of 16 accumulators for K3/K5 and 36 of
// 64 for K4 at p = 1 (3D), 55 / 210 at p = 2, 210 / 820 at p = 3, and 120
// / 231 for K5 at 2D p = 4 / 5 (3 nb staged values a point).  m21 is
// m12^T and m11, m22 are symmetric bit for bit.  Per point a form stages
// vectors from which an entry is two FMAs (K4/K5: beta, u = -w g / 2 and
// u + w gamma beta, entry u_a beta_b + beta_a u_b + w gamma beta_a beta_b)
// or dim FMAs (K3: w grad phi and grad phi).
//
// What bounds each form on an H100 (3.35 TB/s; 67 TFLOP/s f32, 34 f64),
// and what the design does about it:
// * The fine level (C = 1, 262144 lanes at n = 64) is memory: K3 moves
//   204 B a lane (16 us), K4 396 B a lane per offset (31 us, mostly its
//   4 * 16 f32 outputs), against a few hundred flops a point.  One thread
//   a lane, lanes along threadIdx.x, so every table load and output store
//   coalesces along p; each input read once, each output written once from
//   registers.  With 36 accumulators in place of 64, K4 fits 128
//   registers (__launch_bounds__ minimum 2 blocks of 256 per SM, where 64
//   accumulators took 198 registers and one block); the next point's
//   table loads are issued before the current point's arithmetic (register
//   double-buffering), which covers their latency with few lanes in flight.
// * Coarse levels are occupancy: few lanes (down to 8) and long point loops
//   (C up to 32768 cells a lane).  A lane's points are split over G point
//   ranks, threads of one block in different warps taking interleaved
//   points, and over S blocks (gridDim.y) taking contiguous ranges; the G
//   partials are summed through shared memory in rank order at the end
//   (entry t by point rank t mod G, which also stores it, so the stores
//   spread over all warps), the S partials are written to a workspace
//   [S, E, P] that a second
//   kernel (partials_kernel) sums in block order into the output layout:
//   the accumulation over the TPU's sequential C grid dimension.  No
//   atomics, so the output is the same bit for bit from run to run.
// * p >= 2 is arithmetic as much as memory (K4 210 entries a point at
//   p = 2).  The E entries are split over RE entry ranks (enough that a
//   thread holds at most kMaxAccRegs registers of accumulators; each rank's
//   entries are compile-time constants, by a uniform switch on the rank).
//   With RE > 1 at p >= 2 the block stages the values of a chunk of points
//   for its lanes in shared memory, double-buffered, the next chunk while
//   every rank accumulates its entries from this one, with one barrier per
//   chunk.  Elsewhere (p = 1, or one entry rank) each thread evaluates the
//   point values it needs itself: no shared memory, no barrier per point.
// No tensor cores: the f32 band is sensitive to single ulps (gamma below).
// The launch plan (lanes a block holds L, point ranks G, blocks a lane S)
// is chosen in Python (ops/sipg_kernels.py sipg_launch_plan) from what
// pd_sipg_form_info reports of the form (E, RE, threads a block), and
// checked here: L and G powers of two, L * RE * G the block.  The staged
// chunk is sized here, from the bytes of shared memory the plan allows.
//
// Types: f32 and f64 tables; accumulation in the table type.  Index
// arithmetic is 64-bit.  Plain C interface for ctypes (built by
// polydeal_tpu_torch/ops/_build.py): each entry point launches on the given
// stream and returns cudaGetLastError() (0 on success), -1 for a type,
// dimension or degree it was not built for, or -2 for a plan it cannot
// run.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DType { F32 = 0, F64 = 1 };

constexpr int kThreads = 256;    // threads per block
constexpr int kMaxAccRegs = 64;  // accumulator registers one thread holds
constexpr int kRed = 8;          // accumulators summed over ranks per round
constexpr size_t kSmemBlock = 227 * 1024;  // shared memory a block may use
// the entry ranks K5 alone at 2D p = 4-5 takes at least in f64 (E = 120,
// 231 entries)
constexpr int kHighRanksF64 = 8;

__host__ __device__ constexpr int binom(int n, int k) {
  int r = 1;
  for (int i = 1; i <= k; ++i) r = r * (n - k + i) / i;
  return r;
}

// Multi-indices alpha with |alpha| <= DEG in graded order, each grade in
// lexicographic order with the first index slowest: the table of
// fem/basis.py _complete_exponents.
template <int DIM, int DEG>
struct Exponents {
  static constexpr int NB = binom(DEG + DIM, DIM);
  int e[NB][DIM];
  __host__ __device__ constexpr Exponents() : e{} {
    int k = 0;
    for (int total = 0; total <= DEG; ++total) {
      int a[DIM] = {};
      while (true) {
        int s = 0;
        for (int d = 0; d < DIM; ++d) s += a[d];
        if (s == total) {
          for (int d = 0; d < DIM; ++d) e[k][d] = a[d];
          ++k;
        }
        int d = DIM - 1;
        while (d >= 0 && a[d] == total) a[d--] = 0;
        if (d < 0) break;
        ++a[d];
      }
    }
  }
};

// The upper triangle (a <= b) of an M x M matrix, row by row: entry k of a
// symmetric form is (a[k], b[k]).
template <int M>
struct Triangle {
  static constexpr int E = M * (M + 1) / 2;
  int a[E], b[E];
  __host__ __device__ constexpr Triangle() : a{}, b{} {
    int k = 0;
    for (int i = 0; i < M; ++i)
      for (int j = i; j < M; ++j) {
        a[k] = i;
        b[k] = j;
        ++k;
      }
  }
};

// Values phi_i and real gradients dphi_i/dx_e of the Legendre P_p basis at
// one unit point, in the operation order of fem/basis.py _tables_t.
template <typename T, int DIM, int DEG>
struct Basis {
  // degrees 1-3 for every form; 4-5 in 2D, where K5 alone is built
  static_assert(DEG >= 1 && DEG <= (DIM == 2 ? 5 : 3),
                "built for degrees 1-3, and 4-5 in 2D");
  static constexpr int NB = binom(DEG + DIM, DIM);

  __device__ __forceinline__ static void eval(const T (&x)[DIM],
                                              const T (&inv_ext)[DIM],
                                              T (&B)[NB], T (&G)[NB][DIM]) {
    constexpr double kScale[6] = {1.0, 1.7320508075688772, 2.23606797749979,
                                  2.6457513110645907, 3.0,
                                  3.3166247903554};  // sqrt(2k + 1)
    T v[DIM][DEG + 1], dv[DIM][DEG + 1];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const T t = T(2) * x[d] - T(1);
      T pv[DEG + 1], pd[DEG + 1];
      pv[0] = T(1);
      pd[0] = T(0);
      pv[1] = t;
      pd[1] = T(1);
#pragma unroll
      for (int k = 1; k < DEG; ++k) {
        pv[k + 1] = (T(2 * k + 1) * t * pv[k] - T(k) * pv[k - 1]) / T(k + 1);
        pd[k + 1] = pd[k - 1] + T(2 * k + 1) * pv[k];
      }
#pragma unroll
      for (int k = 0; k <= DEG; ++k) {
        v[d][k] = pv[k] * T(kScale[k]);
        dv[d][k] = pd[k] * T(2.0 * kScale[k]);
      }
    }
    constexpr Exponents<DIM, DEG> E{};
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      T b = v[0][E.e[i][0]];
#pragma unroll
      for (int d = 1; d < DIM; ++d) b = b * v[d][E.e[i][d]];
      B[i] = b;
#pragma unroll
      for (int g = 0; g < DIM; ++g) {
        T r = (g == 0 ? dv[0][E.e[i][0]] : v[0][E.e[i][0]]);
#pragma unroll
        for (int d = 1; d < DIM; ++d)
          r = r * (g == d ? dv[d][E.e[i][d]] : v[d][E.e[i][d]]);
        G[i][g] = r * inv_ext[g];
      }
    }
  }
};

// --- the three forms ------------------------------------------------------
// Each form gives: M (its symmetric matrix is M x M; NS sides of NB rows),
// kValues per-point values; Args (table pointers and scalars); Lane, what a
// lane reads once; Raw, a point's table entries, and load(), which reads
// them; values(), which computes a point's values from them and hands
// value k to put(k, value); entry(), which adds one point's contribution to
// entry (a, b) from those values (get(k) returns value k).

template <typename T_, int DIM, int DEG>
struct VolumeForm {  // K3
  using T = T_;
  static constexpr int kDegree = DEG;
  static constexpr int NB = binom(DEG + DIM, DIM);
  static constexpr int NS = 1;
  static constexpr int M = NB;
  static constexpr int kValues = 2 * NB * DIM;  // w grad phi, grad phi
  struct Args {
    const T* pts;
    const T* w;
    const T* ext;
  };
  struct Lane {
    T inv[DIM];
  };
  struct Raw {
    T x[DIM];
    T w;
  };

  __device__ __forceinline__ static Lane lane(const Args& a, int64_t p,
                                              int64_t P) {
    Lane l;
#pragma unroll
    for (int d = 0; d < DIM; ++d) l.inv[d] = T(1) / a.ext[d * P + p];
    return l;
  }

  __device__ __forceinline__ static Raw load(const Args& a, int n, int Q,
                                             int64_t p, int64_t P) {
    Raw r;
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      r.x[d] = a.pts[(static_cast<int64_t>(n) * DIM + d) * P + p];
    r.w = a.w[static_cast<int64_t>(n) * P + p];
    return r;
  }

  template <class Put>
  __device__ __forceinline__ static void values(const Args&, const Lane& l,
                                                const Raw& r,
                                                const Put& put) {
    T B[NB], G[NB][DIM];
    Basis<T, DIM, DEG>::eval(r.x, l.inv, B, G);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        put(i * DIM + d, r.w * G[i][d]);
        put(NB * DIM + i * DIM + d, G[i][d]);
      }
  }

  template <class Get>
  __device__ __forceinline__ static void entry(const Get& v, int a, int b,
                                               T& acc) {
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      acc = fma(v(a * DIM + d), v(NB * DIM + b * DIM + d), acc);
  }
};

// gamma = penalty / h_f rounded as the plain version rounds it: PyTorch
// evaluates `float / tensor` as reciprocal(tensor) * float.  The f32 band
// is that sensitive to it: with the correctly rounded quotient instead
// (one ulp away), the flagship's f32 solution drifts from the f64 one by
// about 1e-3 in place of about 1e-5, though each block agrees with its
// plain version to an ulp.
// f64 carries no such sensitivity at its precision and keeps the plain
// quotient (the reciprocal's slow path costs an f64 instantiation a
// stack frame).
__device__ __forceinline__ float penalty_over(double penalty, float h_f) {
  return __frcp_rn(h_f) * static_cast<float>(penalty);
}
__device__ __forceinline__ double penalty_over(double penalty, double h_f) {
  return penalty / h_f;
}

// The staged vectors of K4 and K5 for one side at one point: beta_i =
// sign * phi_i at value base + i, u_i = -w/2 dnphi_i (K4) or -w dnphi_i
// (K5) at M + base + i, and u_i + w gamma beta_i at 2 M + base + i, where
// dnphi_i = grad phi_i . n.  Entry (a, b) is then u2_a beta_b + beta_a u_b.
template <typename T, int DIM, int DEG, int M, class Put>
__device__ __forceinline__ void side_values(const T (&x)[DIM],
                                            const T (&inv)[DIM],
                                            const T (&nrm)[DIM], int base,
                                            T sign, T wu, T wg,
                                            const Put& put) {
  constexpr int NB = Basis<T, DIM, DEG>::NB;
  T B[NB], G[NB][DIM];
  Basis<T, DIM, DEG>::eval(x, inv, B, G);
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    T gn = G[i][0] * nrm[0];
#pragma unroll
    for (int d = 1; d < DIM; ++d) gn += G[i][d] * nrm[d];
    const T beta = sign * B[i];
    const T u = wu * gn;
    put(base + i, beta);
    put(M + base + i, u);
    put(2 * M + base + i, fma(wg, beta, u));
  }
}

// entry (a, b) of K4 and K5 from side_values' vectors
template <int M, typename T, class Get>
__device__ __forceinline__ void trace_entry(const Get& v, int a, int b,
                                            T& acc) {
  acc = fma(v(2 * M + a), v(b), acc);
  acc = fma(v(a), v(M + b), acc);
}

template <typename T_, int DIM, int DEG>
struct BoundaryForm {  // K5
  using T = T_;
  static constexpr int kDegree = DEG;
  static constexpr int NB = binom(DEG + DIM, DIM);
  static constexpr int NS = 1;
  static constexpr int M = NB;
  static constexpr int kValues = 3 * M;
  struct Args {
    const T* pts;
    const T* n;
    const T* w;
    const T* h_f;
    const T* ext;
    double penalty;
  };
  struct Lane {
    T inv[DIM];
  };
  struct Raw {
    T x[DIM], nrm[DIM];
    T w, h_f;
  };

  __device__ __forceinline__ static Lane lane(const Args& a, int64_t p,
                                              int64_t P) {
    Lane l;
#pragma unroll
    for (int d = 0; d < DIM; ++d) l.inv[d] = T(1) / a.ext[d * P + p];
    return l;
  }

  __device__ __forceinline__ static Raw load(const Args& a, int n, int Q,
                                             int64_t p, int64_t P) {
    Raw r;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      r.x[d] = a.pts[(static_cast<int64_t>(n) * DIM + d) * P + p];
      r.nrm[d] = a.n[(static_cast<int64_t>(n) * DIM + d) * P + p];
    }
    r.w = a.w[static_cast<int64_t>(n) * P + p];
    r.h_f = a.h_f[static_cast<int64_t>(n / Q) * P + p];
    return r;
  }

  template <class Put>
  __device__ __forceinline__ static void values(const Args& a, const Lane& l,
                                                const Raw& r,
                                                const Put& put) {
    const T wg = r.w * penalty_over(a.penalty, r.h_f);
    side_values<T, DIM, DEG, M>(r.x, l.inv, r.nrm, 0, T(1), -r.w, wg, put);
  }

  template <class Get>
  __device__ __forceinline__ static void entry(const Get& v, int a, int b,
                                               T& acc) {
    trace_entry<M>(v, a, b, acc);
  }
};

template <typename T_, int DIM, int DEG>
struct FaceForm {  // K4
  using T = T_;
  static constexpr int kDegree = DEG;
  static constexpr int NB = binom(DEG + DIM, DIM);
  static constexpr int NS = 2;
  static constexpr int M = 2 * NB;
  static constexpr int kValues = 3 * M;
  struct Args {
    const T* pts;
    const T* n;
    const T* w;
    const T* h_f;
    const T* ext;
    const T* lo;
    int64_t offset;
    double penalty;
  };
  struct Lane {
    T lo0[DIM], ext0[DIM], inv0[DIM], lo1[DIM], ext1[DIM], inv1[DIM];
  };
  using Raw = typename BoundaryForm<T, DIM, DEG>::Raw;

  __device__ __forceinline__ static Lane lane(const Args& a, int64_t p,
                                              int64_t P) {
    const int64_t po = (p + a.offset) % P;  // torch.roll(., -offset) wrap
    Lane l;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      l.lo0[d] = a.lo[d * P + p];
      l.ext0[d] = a.ext[d * P + p];
      l.inv0[d] = T(1) / l.ext0[d];
      l.lo1[d] = a.lo[d * P + po];
      l.ext1[d] = a.ext[d * P + po];
      l.inv1[d] = T(1) / l.ext1[d];
    }
    return l;
  }

  __device__ __forceinline__ static Raw load(const Args& a, int n, int Q,
                                             int64_t p, int64_t P) {
    const typename BoundaryForm<T, DIM, DEG>::Args b{a.pts, a.n,   a.w,
                                                     a.h_f, a.ext, 0.0};
    return BoundaryForm<T, DIM, DEG>::load(b, n, Q, p, P);
  }

  template <class Put>
  __device__ __forceinline__ static void values(const Args& a, const Lane& l,
                                                const Raw& r,
                                                const Put& put) {
    T x1[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d)  // the same physical point, neighbour box
      x1[d] = (l.lo0[d] + r.x[d] * l.ext0[d] - l.lo1[d]) / l.ext1[d];
    const T wg = r.w * penalty_over(a.penalty, r.h_f);
    const T wu = T(-0.5) * r.w;
    side_values<T, DIM, DEG, M>(r.x, l.inv0, r.nrm, 0, T(1), wu, wg, put);
    side_values<T, DIM, DEG, M>(x1, l.inv1, r.nrm, NB, T(-1), wu, wg, put);
  }

  template <class Get>
  __device__ __forceinline__ static void entry(const Get& v, int a, int b,
                                               T& acc) {
    trace_entry<M>(v, a, b, acc);
  }
};

// --- one kernel for the three forms -----------------------------------------

__host__ __device__ constexpr int entry_ranks(int entries, int cap) {
  // entry ranks: the least power of two that leaves a thread at most cap
  // accumulators
  int r = 1;
  while ((entries + r - 1) / r > cap) r *= 2;
  return r;
}

// How a form's E distinct entries split over RE entry ranks of PER each,
// and how it runs: staged (point values through shared memory, shared by
// the entry ranks) at p >= 2 where there is more than one entry rank; else
// each thread evaluates its own points.  At p = 1 in f32 a thread keeps to
// 128 registers (two blocks an SM).  K5 alone at 2D p = 4-5 in f64
// (kHighF64) takes at least kHighRanksF64 entry ranks, and a thread of at
// most 16 accumulators keeps to 128 registers: at p = 4, 8 ranks of 15 in
// place of 4 of 30, two blocks an SM in place of one (p = 5 takes 8
// ranks anyway).  In f32 neither more ranks nor fewer registers beat the
// 64-register split.
template <class F>
struct Split {
  using T = typename F::T;
  static constexpr bool kHighF64 = F::kDegree >= 4 && sizeof(T) == 8;
  static constexpr int E = F::M * (F::M + 1) / 2;
  static constexpr int RE0 =
      entry_ranks(E, kMaxAccRegs * 4 / static_cast<int>(sizeof(T)));
  static constexpr int RE =
      kHighF64 && RE0 < kHighRanksF64 ? kHighRanksF64 : RE0;
  static constexpr int PER = (E + RE - 1) / RE;
  static constexpr bool kStaged = F::kDegree >= 2 && RE > 1;
  static constexpr int kMinBlocks =
      (F::kDegree == 1 && sizeof(T) == 4) || (kHighF64 && PER <= 16) ? 2
                                                                       : 1;
  static_assert(kThreads % RE == 0, "entry ranks must divide the block");
};

// Output row of entry (a, b): block (a / NB, b / NB) of the NS x NS
// blocks, row (a % NB) * NB + b % NB within it.
template <class F>
__host__ __device__ constexpr int out_row(int a, int b) {
  return ((a / F::NB) * F::NS + b / F::NB) * F::NB * F::NB +
         (a % F::NB) * F::NB + b % F::NB;
}

// Calls fn(std::integral_constant<int, R>) for R = e: a uniform switch on
// the entry rank, so each rank's entries are compile-time constants.
template <class F, int R = 0, class Fn>
__device__ __forceinline__ void with_rank(int e, const Fn& fn) {
  if constexpr (R < Split<F>::RE) {
    if (e == R)
      fn(std::integral_constant<int, R>{});
    else
      with_rank<F, R + 1>(e, fn);
  }
}

template <class F, int R>
struct Rank {  // entries [E0, E0 + NE) of entry rank R
  static constexpr int E0 = R * Split<F>::PER;
  static constexpr int NE = Split<F>::E - E0 < Split<F>::PER
                                ? Split<F>::E - E0
                                : Split<F>::PER;
};

template <class F, int R, class Get>
__device__ __forceinline__ void accumulate(
    typename F::T (&acc)[Split<F>::PER], const Get& v) {
  constexpr Triangle<F::M> tri{};
  using K = Rank<F, R>;
#pragma unroll
  for (int t = 0; t < K::NE; ++t)
    F::entry(v, tri.a[K::E0 + t], tri.b[K::E0 + t], acc[t]);
}

// rank R's sums: into the output layout (both places of entry (a, b)), or
// into this block's rows of the workspace [S, E, P] (ws points at them);
// point rank g of G stores the entries t = g mod G
template <class F, int R>
__device__ __forceinline__ void store(
    const typename F::T (&acc)[Split<F>::PER], typename F::T* out,
    typename F::T* ws, int64_t p, int64_t P, int G, int g) {
  constexpr Triangle<F::M> tri{};
  using K = Rank<F, R>;
#pragma unroll
  for (int t = 0; t < K::NE; ++t) {
    if (G > 1 && (t & (G - 1)) != g) continue;
    if (ws != nullptr) {
      ws[static_cast<int64_t>(K::E0 + t) * P + p] = acc[t];
    } else {
      const int a = tri.a[K::E0 + t], b = tri.b[K::E0 + t];
      out[static_cast<int64_t>(out_row<F>(a, b)) * P + p] = acc[t];
      if (a != b) out[static_cast<int64_t>(out_row<F>(b, a)) * P + p] = acc[t];
    }
  }
}

// staged values: per lane CH points of kValues, at an odd stride (in
// elements) so that the lanes of a warp fall in different banks
__host__ __device__ constexpr int64_t lane_stride(int CH, int values) {
  return (static_cast<int64_t>(CH) * values) | 1;
}

// Thread t of a block: lane t % L (lanes p along threadIdx.x), rank
// r = t / L = e * G + g: entry rank e, point rank g (a warp holds one entry
// rank, also where L < 32).  Block (x, s) holds
// lanes [x L, x L + L) and points [s N / S, (s + 1) N / S) of each; point
// rank g takes every G-th of those from the g-th.  Every thread passes every
// barrier: lanes past P carry zeros.
template <class F>
__global__ void __launch_bounds__(kThreads, Split<F>::kMinBlocks)
    blocks_kernel(const typename F::Args a, int Q, int N, int64_t P, int L,
                  int G, int CH, typename F::T* __restrict__ out,
                  typename F::T* __restrict__ ws) {
  using T = typename F::T;
  using S = Split<F>;
  __shared__ T red[kRed][kThreads];
  // L and G are powers of two: shifts and masks, not divisions
  const int lane = threadIdx.x & (L - 1);
  const int r = threadIdx.x >> (__ffs(L) - 1);
  const int e = r >> (__ffs(G) - 1);
  const int g = r & (G - 1);
  const int64_t p = static_cast<int64_t>(blockIdx.x) * L + lane;
  const bool live = p < P;
  int n0 = 0, n1 = N;
  if (gridDim.y > 1) {
    n0 = static_cast<int>(static_cast<int64_t>(blockIdx.y) * N / gridDim.y);
    n1 = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * N /
                          gridDim.y);
  }
  T acc[S::PER];
#pragma unroll
  for (int t = 0; t < S::PER; ++t) acc[t] = T(0);

  if constexpr (!S::kStaged) {
    if (live && n0 + g < n1) {
      const typename F::Lane l = F::lane(a, p, P);
      typename F::Raw next = F::load(a, n0 + g, Q, p, P);
      for (int n = n0 + g; n < n1; n += G) {
        const typename F::Raw cur = next;
        if (n + G < n1) next = F::load(a, n + G, Q, p, P);  // in flight
        T v[F::kValues];
        F::values(a, l, cur, [&](int k, T x) { v[k] = x; });
        const auto get = [&](int k) { return v[k]; };
        with_rank<F>(e, [&](auto R) {
          accumulate<F, decltype(R)::value>(acc, get);
        });
      }
    }
  } else {
    extern __shared__ unsigned char smem[];
    T* sv = reinterpret_cast<T*>(smem);  // [2][L][lane_stride]
    const int64_t ls = lane_stride(CH, F::kValues);
    const int ranks = kThreads / L;
    typename F::Lane l;
    if (live) l = F::lane(a, p, P);
    // the values of the chunk of points from c0 into buffer b, and their
    // sums from it
    const auto stage = [&](int c0, int b) {
      const int len = min(CH, n1 - c0);
      T* mine = sv + (static_cast<int64_t>(b) * L + lane) * ls;
      if (live) {
        for (int j = r; j < len; j += ranks) {
          const typename F::Raw raw = F::load(a, c0 + j, Q, p, P);
          T* pv = mine + j * F::kValues;
          F::values(a, l, raw, [&](int k, T x) { pv[k] = x; });
        }
      }
    };
    const auto sum = [&](int c0, int b) {
      const int len = min(CH, n1 - c0);
      const T* mine = sv + (static_cast<int64_t>(b) * L + lane) * ls;
      if (live) {
        for (int j = g; j < len; j += G) {
          const T* pv = mine + j * F::kValues;
          const auto get = [&](int k) { return pv[k]; };
          with_rank<F>(e, [&](auto R) {
            accumulate<F, decltype(R)::value>(acc, get);
          });
        }
      }
    };
    // the next chunk is staged while this one is summed, so that its table
    // loads and basis evaluation overlap the sums; one barrier a chunk: a
    // buffer is staged again only after the barrier that ends its sums
    stage(n0, 0);
    __syncthreads();
    int buf = 0;
    for (int c0 = n0; c0 < n1; c0 += CH, buf ^= 1) {
      if (c0 + CH < n1) stage(c0 + CH, buf ^ 1);
      sum(c0, buf);
      __syncthreads();
    }
  }

  // the G point ranks' partials: entry t summed in rank order by point
  // rank t mod G, which stores it, so every rank shares the stores
  if (G > 1) {
    const int first = threadIdx.x - g * L;  // point rank 0 of this lane
#pragma unroll
    for (int t0 = 0; t0 < S::PER; t0 += kRed) {
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kRed && t0 + t < S::PER; ++t)
        red[t][threadIdx.x] = acc[t0 + t];
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kRed && t0 + t < S::PER; ++t) {
        if (((t0 + t) & (G - 1)) == g) {
          T s = red[t][first];
          for (int h = 1; h < G; ++h) s += red[t][first + h * L];
          acc[t0 + t] = s;
        }
      }
    }
  }
  if (live) {
    T* part = gridDim.y > 1
                  ? ws + static_cast<int64_t>(blockIdx.y) * S::E * P
                  : nullptr;
    with_rank<F>(e, [&](auto R) {
      store<F, decltype(R)::value>(acc, out, part, p, P, G, g);
    });
  }
}

// The second pass over S > 1: out gets the sum over s, in order, of the
// workspace [S, E, P], entry k of lane p by thread (p, k), in both places.
template <class F>
__global__ void __launch_bounds__(kThreads)
    partials_kernel(const typename F::T* __restrict__ ws, int S, int64_t P,
                    typename F::T* __restrict__ out) {
  using T = typename F::T;
  constexpr int E = Split<F>::E;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  if (p >= P) return;
  T s = ws[static_cast<int64_t>(k) * P + p];
  for (int j = 1; j < S; ++j)
    s += ws[(static_cast<int64_t>(j) * E + k) * P + p];
  int a = 0, rest = k;  // entry k of the triangle, row by row
  while (rest >= F::M - a) rest -= F::M - a++;
  const int b = a + rest;
  out[static_cast<int64_t>(out_row<F>(a, b)) * P + p] = s;
  if (a != b) out[static_cast<int64_t>(out_row<F>(b, a)) * P + p] = s;
}

template <class F>
int launch(const typename F::Args& a, int C, int Q, int64_t P, int L, int G,
           int S, int64_t stage_bytes, void* out, void* ws, cudaStream_t st) {
  using T = typename F::T;
  using Sp = Split<F>;
  const int64_t N = static_cast<int64_t>(C) * Q;
  if (L <= 0 || G <= 0 || S <= 0 || S > 65535 || N > INT32_MAX ||
      (L & (L - 1)) != 0 || (G & (G - 1)) != 0 ||
      static_cast<int64_t>(L) * Sp::RE * G != kThreads ||
      (S > 1 && ws == nullptr))
    return -2;
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  int CH = 0;
  size_t smem = 0;
  if (Sp::kStaged) {
    // the most whole rounds of G points, no more than a block's points,
    // whose two buffers fit stage_bytes (one round at least)
    const auto bytes = [&](int64_t ch) {
      return 2 * L * lane_stride(static_cast<int>(ch), F::kValues) *
             static_cast<int64_t>(sizeof(T));
    };
    const int64_t per_block = (N + S - 1) / S;
    int64_t ch = G;
    while (ch < per_block && bytes(ch + G) <= stage_bytes) ch += G;
    CH = static_cast<int>(ch);
    smem = static_cast<size_t>(bytes(ch));
    if (smem + sizeof(T) * kRed * kThreads > kSmemBlock) return -2;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(blocks_kernel<F>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  }
  const dim3 grid(static_cast<unsigned int>((P + L - 1) / L),
                  static_cast<unsigned int>(S));
  blocks_kernel<F><<<grid, kThreads, smem, st>>>(
      a, Q, static_cast<int>(N), P, L, G, CH, static_cast<T*>(out),
      S > 1 ? static_cast<T*>(ws) : nullptr);
  if (S > 1)
    partials_kernel<F><<<dim3(static_cast<unsigned int>(
                                  (P + kThreads - 1) / kThreads),
                              Sp::E),
                         kThreads, 0, st>>>(static_cast<const T*>(ws), S, P,
                                            static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

struct Plan {  // the launch plan's runtime arguments
  int L, G, S;
  int64_t stage_bytes;
  void* ws;
};

template <typename T, int DIM, int DEG>
int volume(const void* pts, const void* w, const void* ext, int C, int Q,
           int64_t P, Plan pl, void* out, cudaStream_t s) {
  using F = VolumeForm<T, DIM, DEG>;
  const typename F::Args a{static_cast<const T*>(pts),
                           static_cast<const T*>(w),
                           static_cast<const T*>(ext)};
  return launch<F>(a, C, Q, P, pl.L, pl.G, pl.S, pl.stage_bytes, out, pl.ws,
                   s);
}

template <typename T, int DIM, int DEG>
int boundary(const void* pts, const void* n, const void* w, const void* h_f,
             const void* ext, double penalty, int C, int Q, int64_t P,
             Plan pl, void* out, cudaStream_t s) {
  using F = BoundaryForm<T, DIM, DEG>;
  const typename F::Args a{
      static_cast<const T*>(pts), static_cast<const T*>(n),
      static_cast<const T*>(w),   static_cast<const T*>(h_f),
      static_cast<const T*>(ext), penalty};
  return launch<F>(a, C, Q, P, pl.L, pl.G, pl.S, pl.stage_bytes, out, pl.ws,
                   s);
}

template <typename T, int DIM, int DEG>
int face(const void* pts, const void* n, const void* w, const void* h_f,
         const void* ext, const void* lo, int64_t offset, double penalty,
         int C, int Q, int64_t P, Plan pl, void* out, cudaStream_t s) {
  using F = FaceForm<T, DIM, DEG>;
  const typename F::Args a{
      static_cast<const T*>(pts), static_cast<const T*>(n),
      static_cast<const T*>(w),   static_cast<const T*>(h_f),
      static_cast<const T*>(ext), static_cast<const T*>(lo),
      offset,                     penalty};
  return launch<F>(a, C, Q, P, pl.L, pl.G, pl.S, pl.stage_bytes, out, pl.ws,
                   s);
}

// What the launch plan needs of form F: info = {E distinct entries, RE
// entry ranks, threads a block, bytes of an element}.
template <class F>
int form_info(long long* info) {
  info[0] = Split<F>::E;
  info[1] = Split<F>::RE;
  info[2] = kThreads;
  info[3] = sizeof(typename F::T);
  return 0;
}

// kind 0 volume (K3), 1 face (K4), 2 boundary (K5)
template <typename T, int DIM, int DEG>
int form_of(int kind, long long* out) {
  switch (kind) {
    case 0: return form_info<VolumeForm<T, DIM, DEG>>(out);
    case 1: return form_info<FaceForm<T, DIM, DEG>>(out);
    case 2: return form_info<BoundaryForm<T, DIM, DEG>>(out);
    default: return -1;
  }
}

// K5 alone at 2D p = 4-5 (nb = 15, 21; E = 120, 231 entries): the JAX
// package's rule gives its Pallas kernel the boundary blocks there and
// leaves the volume and face blocks to XLA (ops/sipg_kernels.py
// kernel_blocks)
template <typename T, int DIM, int DEG>
int boundary_form_of(int kind, long long* out) {
  return kind == 2 ? form_info<BoundaryForm<T, DIM, DEG>>(out) : -1;
}

// Calls FN<T, DIM, DEG>(args...) for the (type, dim, degree) triples built
// for every form ...
#define PD_SIPG_CASES(FN, T, code, ...)                                   \
  case code * 100 + 21: return FN<T, 2, 1>(__VA_ARGS__);                  \
  case code * 100 + 22: return FN<T, 2, 2>(__VA_ARGS__);                  \
  case code * 100 + 23: return FN<T, 2, 3>(__VA_ARGS__);                  \
  case code * 100 + 31: return FN<T, 3, 1>(__VA_ARGS__);                  \
  case code * 100 + 32: return FN<T, 3, 2>(__VA_ARGS__);                  \
  case code * 100 + 33: return FN<T, 3, 3>(__VA_ARGS__);
#define PD_SIPG_DISPATCH(FN, dt, dim, deg, ...)                           \
  switch (dt * 100 + dim * 10 + deg) {                                    \
    PD_SIPG_CASES(FN, float, F32, __VA_ARGS__)                            \
    PD_SIPG_CASES(FN, double, F64, __VA_ARGS__)                           \
    default: return -1;                                                   \
  }
// ... and for K5 alone
#define PD_SIPG_BOUNDARY_CASES(FN, T, code, ...)                          \
  case code * 100 + 24: return FN<T, 2, 4>(__VA_ARGS__);                  \
  case code * 100 + 25: return FN<T, 2, 5>(__VA_ARGS__);
#define PD_SIPG_BOUNDARY_DISPATCH(FN, dt, dim, deg, ...)                  \
  switch (dt * 100 + dim * 10 + deg) {                                    \
    PD_SIPG_BOUNDARY_CASES(FN, float, F32, __VA_ARGS__)                   \
    PD_SIPG_BOUNDARY_CASES(FN, double, F64, __VA_ARGS__)                  \
    default: return -1;                                                   \
  }

bool built(int dim, int degree) {
  return dim >= 2 && dim <= 3 && degree >= 1 && degree <= 3;
}

bool boundary_only(int dim, int degree) {
  return dim == 2 && (degree == 4 || degree == 5);
}

}  // namespace

extern "C" int pd_sipg_form_info(int dt, int dim, int degree, int kind,
                                 long long* info) {
  if (boundary_only(dim, degree)) {
    PD_SIPG_BOUNDARY_DISPATCH(boundary_form_of, dt, dim, degree, kind, info)
  }
  if (!built(dim, degree)) return -1;
  PD_SIPG_DISPATCH(form_of, dt, dim, degree, kind, info)
}

// Each entry takes the launch plan after P: lanes a block holds L, point
// ranks G, blocks a lane S, the bytes of shared memory its staged point
// values may take (p >= 2 with several entry ranks) and the workspace
// [S, E, P] of the table type (may be null when S = 1).
extern "C" int pd_sipg_volume(int dt, int dim, int degree, const void* pts,
                              const void* w, const void* ext, int C, int Q,
                              long long P, int L, int G, int S,
                              long long stage_bytes, void* ws, void* out,
                              void* stream) {
  if (!built(dim, degree)) return -1;
  const Plan pl{L, G, S, stage_bytes, ws};
  PD_SIPG_DISPATCH(volume, dt, dim, degree, pts, w, ext, C, Q,
                   static_cast<int64_t>(P), pl, out,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int pd_sipg_boundary(int dt, int dim, int degree, const void* pts,
                                const void* n, const void* w,
                                const void* h_f, const void* ext,
                                double penalty, int C, int Q, long long P,
                                int L, int G, int S, long long stage_bytes,
                                void* ws, void* out, void* stream) {
  const Plan pl{L, G, S, stage_bytes, ws};
  if (boundary_only(dim, degree)) {
    PD_SIPG_BOUNDARY_DISPATCH(boundary, dt, dim, degree, pts, n, w, h_f,
                              ext, penalty, C, Q, static_cast<int64_t>(P),
                              pl, out, static_cast<cudaStream_t>(stream));
  }
  if (!built(dim, degree)) return -1;
  PD_SIPG_DISPATCH(boundary, dt, dim, degree, pts, n, w, h_f, ext, penalty,
                   C, Q, static_cast<int64_t>(P), pl, out,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int pd_sipg_face(int dt, int dim, int degree, const void* pts,
                            const void* n, const void* w, const void* h_f,
                            const void* ext, const void* lo, long long offset,
                            double penalty, int C, int Q, long long P, int L,
                            int G, int S, long long stage_bytes, void* ws,
                            void* out, void* stream) {
  if (!built(dim, degree)) return -1;
  const Plan pl{L, G, S, stage_bytes, ws};
  PD_SIPG_DISPATCH(face, dt, dim, degree, pts, n, w, h_f, ext, lo,
                   static_cast<int64_t>(offset), penalty, C, Q,
                   static_cast<int64_t>(P), pl, out,
                   static_cast<cudaStream_t>(stream));
}
