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
//   K3  out[i*nb + j, p] = sum_{c,q} w * sum_d dphi_i/dx_d * dphi_j/dx_d
//   K5  out[i*nb + j, p] = sum_{c,q} w * (-phi_i dnphi_j - dnphi_i phi_j
//                                         + gamma phi_i phi_j)
//   K4  out[k, i*nb + j, p] for k = m11, m12, m21, m22, where i lives on
//       side X = k / 2 and j on side Y = k % 2 (side 0 is polytope p, side 1
//       its neighbour p + offset):
//       sum_{c,q} w * (a dnphiX_i phiY_j + b phiX_i dnphiY_j
//                      + c gamma phiX_i phiY_j),
//       a = Y ? 1/2 : -1/2, b = X ? 1/2 : -1/2, c = X == Y ? 1 : -1
//       (reference poly_utils.h:1870-1926).
// gamma = penalty / h_f.  K4's side-1 unit points are the side-0 physical
// points pulled back into the box of lane (p + offset) mod P: the wrap of
// torch.roll, so wrapped lanes stay finite and vanish against zero weights.
// phi is the orthonormal Legendre P_p basis of fem/basis.py, evaluated in
// registers from the unit points: the graded exponent table is a
// compile-time constant, so every (i, d) loop unrolls, and gradients are
// scaled by 1/extent.
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s f32, 34 f64): at p = 1
// memory.  At the flagship fine level (nb = 4, C = 1, P = 262144) K3 moves
// 204 B a lane (53.5 MB, 16 us) and K4 396 B a lane per offset (104 MB,
// 31 us, mostly its 4 * 16 f32 outputs), against a few hundred flops a
// quadrature point.  At p = 2 (nb = 10) K4 does 400 block entries of about
// ten flops a point, and its arithmetic comes close to its bytes.  The
// design does what that needs and no more: lanes map to threads, so every
// table load and every output store coalesces along p; each input is read
// once; each output is written once, from registers, never accumulated in
// device memory (the wrapper allocates it with torch.empty).  The whole
// (c, q) loop of a lane runs inside its thread(s), so no sum crosses a
// block: this replaces the TPU's accumulating inner grid dimension over C.
//
// Registers: a form's entries come in rows of nb (K3, K5: rows i; K4: rows
// (k, i)), and a thread holds whole rows, at most kMaxAccRegs registers of
// accumulators (or one row).  Forms with more (K4 at p >= 2: 400 entries at
// nb = 10, 1600 at nb = 20; K3/K5 at nb >= 10; f64 sooner) split the rows
// across G threads of a lane group.  Rank 0 of the group evaluates the
// lane's per-point values (basis, normal derivatives, w, w*gamma) into
// shared memory and every rank accumulates its rows from there; the column
// j of an entry is a compile-time constant, so a row reads shared memory at
// one runtime base plus constant offsets.  With G = 1 everything stays in
// registers.
// Occupancy: coarse levels have few lanes and long (c, q) loops (512 lanes,
// C up to 512 at the flagship's coarsest level); splitting C across threads
// is left for later.
//
// Types: f32 and f64 tables; accumulation in the table type.  Index
// arithmetic is 64-bit.  Plain C interface for ctypes (built by
// polydeal_tpu_torch/ops/_build.py): each entry point launches on the given
// stream and returns cudaGetLastError() (0 on success), or -1 for a type,
// dimension or degree it was not built for.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { F32 = 0, F64 = 1 };

constexpr int kThreads = 256;    // threads per block
constexpr int kMaxAccRegs = 64;  // accumulator registers one thread holds

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

// Values phi_i and real gradients dphi_i/dx_e of the Legendre P_p basis at
// one unit point, in the operation order of fem/basis.py _tables_t.
template <typename T, int DIM, int DEG>
struct Basis {
  static_assert(DEG >= 1 && DEG <= 3, "built for degrees 1-3");
  static constexpr int NB = binom(DEG + DIM, DIM);

  __device__ __forceinline__ static void eval(const T (&x)[DIM],
                                              const T (&inv_ext)[DIM],
                                              T (&B)[NB], T (&G)[NB][DIM]) {
    constexpr double kScale[4] = {1.0, 1.7320508075688772, 2.23606797749979,
                                  2.6457513110645907};  // sqrt(2k + 1)
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
// Each form gives: kValues per-point values and kRows rows of NB output
// entries per lane (entry (row, j) is output row row * NB + j); Args (table
// pointers and scalars); Lane, what a lane reads once; eval(), which
// computes one (c, q) point's values and hands value k to put(k, value);
// entry(), the contribution of one point to entry (row, j) from those
// values (get(k) returns value k).

template <typename T_, int DIM, int DEG>
struct VolumeForm {  // K3
  using T = T_;
  static constexpr int NB = binom(DEG + DIM, DIM);
  static constexpr int kValues = NB * DIM + 1;  // real gradients, w
  static constexpr int kRows = NB;
  struct Args {
    const T* pts;
    const T* w;
    const T* ext;
  };
  struct Lane {
    T inv[DIM];
  };

  __device__ __forceinline__ static Lane lane(const Args& a, int64_t p,
                                              int64_t P) {
    Lane l;
#pragma unroll
    for (int d = 0; d < DIM; ++d) l.inv[d] = T(1) / a.ext[d * P + p];
    return l;
  }

  template <class Put>
  __device__ __forceinline__ static void eval(const Args& a, const Lane& l,
                                              int64_t cq, int c, int64_t p,
                                              int64_t P, const Put& put) {
    T x[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) x[d] = a.pts[(cq * DIM + d) * P + p];
    T B[NB], G[NB][DIM];
    Basis<T, DIM, DEG>::eval(x, l.inv, B, G);
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int d = 0; d < DIM; ++d) put(i * DIM + d, G[i][d]);
    put(NB * DIM, a.w[cq * P + p]);
  }

  template <class Get>
  __device__ __forceinline__ static T entry(const Get& v, int i, int j) {
    T s = v(i * DIM) * v(j * DIM);
#pragma unroll
    for (int d = 1; d < DIM; ++d) s += v(i * DIM + d) * v(j * DIM + d);
    return s * v(NB * DIM);
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

// phi_i and dnphi_i = grad phi_i . n at one point, for one side
template <typename T, int DIM, int DEG, class Put>
__device__ __forceinline__ void side_values(const T (&x)[DIM],
                                            const T (&inv)[DIM],
                                            const T (&nrm)[DIM], int base,
                                            const Put& put) {
  constexpr int NB = Basis<T, DIM, DEG>::NB;
  T B[NB], G[NB][DIM];
  Basis<T, DIM, DEG>::eval(x, inv, B, G);
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    T gn = G[i][0] * nrm[0];
#pragma unroll
    for (int d = 1; d < DIM; ++d) gn += G[i][d] * nrm[d];
    put(base + i, B[i]);
    put(base + NB + i, gn);
  }
}

template <typename T_, int DIM, int DEG>
struct BoundaryForm {  // K5
  using T = T_;
  static constexpr int NB = binom(DEG + DIM, DIM);
  static constexpr int kValues = 2 * NB + 2;  // phi, dnphi, w, w*gamma
  static constexpr int kRows = NB;
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

  __device__ __forceinline__ static Lane lane(const Args& a, int64_t p,
                                              int64_t P) {
    Lane l;
#pragma unroll
    for (int d = 0; d < DIM; ++d) l.inv[d] = T(1) / a.ext[d * P + p];
    return l;
  }

  template <class Put>
  __device__ __forceinline__ static void eval(const Args& a, const Lane& l,
                                              int64_t cq, int c, int64_t p,
                                              int64_t P, const Put& put) {
    T x[DIM], nrm[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      x[d] = a.pts[(cq * DIM + d) * P + p];
      nrm[d] = a.n[(cq * DIM + d) * P + p];
    }
    side_values<T, DIM, DEG>(x, l.inv, nrm, 0, put);
    const T w = a.w[cq * P + p];
    const T gamma =
        penalty_over(a.penalty, a.h_f[static_cast<int64_t>(c) * P + p]);
    put(2 * NB, w);
    put(2 * NB + 1, w * gamma);
  }

  template <class Get>
  __device__ __forceinline__ static T entry(const Get& v, int i, int j) {
    const T bi = v(i), bj = v(j), gi = v(NB + i), gj = v(NB + j);
    return v(2 * NB) * (-(bi * gj) - gi * bj) + v(2 * NB + 1) * bi * bj;
  }
};

template <typename T_, int DIM, int DEG>
struct FaceForm {  // K4
  using T = T_;
  static constexpr int NB = binom(DEG + DIM, DIM);
  // phi0, dnphi0, phi1, dnphi1, w, w*gamma
  static constexpr int kValues = 4 * NB + 2;
  static constexpr int kRows = 4 * NB;  // (k, i)
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

  template <class Put>
  __device__ __forceinline__ static void eval(const Args& a, const Lane& l,
                                              int64_t cq, int c, int64_t p,
                                              int64_t P, const Put& put) {
    T x0[DIM], x1[DIM], nrm[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      x0[d] = a.pts[(cq * DIM + d) * P + p];
      nrm[d] = a.n[(cq * DIM + d) * P + p];
      // the same physical point in the neighbour's unit box
      x1[d] = (l.lo0[d] + x0[d] * l.ext0[d] - l.lo1[d]) / l.ext1[d];
    }
    side_values<T, DIM, DEG>(x0, l.inv0, nrm, 0, put);
    side_values<T, DIM, DEG>(x1, l.inv1, nrm, 2 * NB, put);
    const T w = a.w[cq * P + p];
    const T gamma =
        penalty_over(a.penalty, a.h_f[static_cast<int64_t>(c) * P + p]);
    put(4 * NB, w);
    put(4 * NB + 1, w * gamma);
  }

  template <class Get>
  __device__ __forceinline__ static T entry(const Get& v, int row, int j) {
    const int k = row / NB, i = row % NB;
    const int X = k >> 1, Y = k & 1;
    const T bi = v(2 * NB * X + i), gi = v(2 * NB * X + NB + i);
    const T bj = v(2 * NB * Y + j), gj = v(2 * NB * Y + NB + j);
    const T a = Y ? T(0.5) : T(-0.5);
    const T b = X ? T(0.5) : T(-0.5);
    const T s = (X == Y) ? T(1) : T(-1);
    return v(4 * NB) * (a * gi * bj + b * bi * gj) +
           s * v(4 * NB + 1) * bi * bj;
  }
};

// --- one kernel for the three forms -----------------------------------------

template <class F>
__host__ __device__ constexpr int ranks_of() {
  // threads per lane: enough that each holds kMaxAccRegs registers of
  // accumulators, or one row
  constexpr int cap =
      kMaxAccRegs * 4 / static_cast<int>(sizeof(typename F::T));
  int g = 1;
  while ((F::kRows + g - 1) / g > 1 && (F::kRows + g - 1) / g * F::NB > cap)
    g *= 2;
  return g;
}

template <class F>
__global__ void __launch_bounds__(kThreads)
    blocks_kernel(const typename F::Args a, int C, int Q, int64_t P,
                  typename F::T* __restrict__ out) {
  using T = typename F::T;
  constexpr int NB = F::NB;
  constexpr int G = ranks_of<F>();
  constexpr int L = kThreads / G;  // lanes per block
  constexpr int RT = (F::kRows + G - 1) / G;  // rows per thread
  static_assert(kThreads % G == 0, "a lane group must divide the block");
  const int lane = threadIdx.x % L;
  const int rank = threadIdx.x / L;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * L + lane;
  const bool live = p < P;
  T acc[RT][NB];
#pragma unroll
  for (int t = 0; t < RT; ++t)
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[t][j] = T(0);

  if constexpr (G == 1) {
    if (!live) return;
    const typename F::Lane l = F::lane(a, p, P);
    for (int c = 0; c < C; ++c) {
      for (int q = 0; q < Q; ++q) {
        T v[F::kValues];
        F::eval(a, l, static_cast<int64_t>(c) * Q + q, c, p, P,
                [&](int k, T x) { v[k] = x; });
        const auto get = [&](int k) { return v[k]; };
#pragma unroll
        for (int t = 0; t < RT; ++t)
#pragma unroll
          for (int j = 0; j < NB; ++j) acc[t][j] += F::entry(get, t, j);
      }
    }
#pragma unroll
    for (int t = 0; t < RT; ++t)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        out[static_cast<int64_t>(t * NB + j) * P + p] = acc[t][j];
  } else {
    __shared__ T sv[F::kValues][L];
    typename F::Lane l;
    if (rank == 0 && live) l = F::lane(a, p, P);
    for (int c = 0; c < C; ++c) {
      for (int q = 0; q < Q; ++q) {
        __syncthreads();  // every rank is done with the previous point
        if (rank == 0 && live)
          F::eval(a, l, static_cast<int64_t>(c) * Q + q, c, p, P,
                  [&](int k, T x) { sv[k][lane] = x; });
        __syncthreads();
        if (live) {
          const auto get = [&](int k) { return sv[k][lane]; };
#pragma unroll
          for (int t = 0; t < RT; ++t) {
            const int row = rank * RT + t;
            if (row < F::kRows) {
#pragma unroll
              for (int j = 0; j < NB; ++j) acc[t][j] += F::entry(get, row, j);
            }
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        const int row = rank * RT + t;
        if (row < F::kRows) {
#pragma unroll
          for (int j = 0; j < NB; ++j)
            out[static_cast<int64_t>(row * NB + j) * P + p] = acc[t][j];
        }
      }
    }
  }
}

template <class F>
int launch(const typename F::Args& a, int C, int Q, int64_t P, void* out,
           cudaStream_t s) {
  constexpr int L = kThreads / ranks_of<F>();
  if (P > 0) {
    const unsigned int blocks = static_cast<unsigned int>((P + L - 1) / L);
    blocks_kernel<F><<<blocks, kThreads, 0, s>>>(
        a, C, Q, P, static_cast<typename F::T*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DIM, int DEG>
int volume(const void* pts, const void* w, const void* ext, int C, int Q,
           int64_t P, void* out, cudaStream_t s) {
  using F = VolumeForm<T, DIM, DEG>;
  const typename F::Args a{static_cast<const T*>(pts),
                           static_cast<const T*>(w),
                           static_cast<const T*>(ext)};
  return launch<F>(a, C, Q, P, out, s);
}

template <typename T, int DIM, int DEG>
int boundary(const void* pts, const void* n, const void* w, const void* h_f,
             const void* ext, double penalty, int C, int Q, int64_t P,
             void* out, cudaStream_t s) {
  using F = BoundaryForm<T, DIM, DEG>;
  const typename F::Args a{
      static_cast<const T*>(pts), static_cast<const T*>(n),
      static_cast<const T*>(w),   static_cast<const T*>(h_f),
      static_cast<const T*>(ext), penalty};
  return launch<F>(a, C, Q, P, out, s);
}

template <typename T, int DIM, int DEG>
int face(const void* pts, const void* n, const void* w, const void* h_f,
         const void* ext, const void* lo, int64_t offset, double penalty,
         int C, int Q, int64_t P, void* out, cudaStream_t s) {
  using F = FaceForm<T, DIM, DEG>;
  const typename F::Args a{
      static_cast<const T*>(pts), static_cast<const T*>(n),
      static_cast<const T*>(w),   static_cast<const T*>(h_f),
      static_cast<const T*>(ext), static_cast<const T*>(lo),
      offset,                     penalty};
  return launch<F>(a, C, Q, P, out, s);
}

// Calls FN<T, DIM, DEG>(args...) for the built (type, dim, degree) triples.
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

}  // namespace

extern "C" int pd_sipg_volume(int dt, int dim, int degree, const void* pts,
                              const void* w, const void* ext, int C, int Q,
                              long long P, void* out, void* stream) {
  if (dim < 2 || dim > 3 || degree < 1 || degree > 3) return -1;
  PD_SIPG_DISPATCH(volume, dt, dim, degree, pts, w, ext, C, Q,
                   static_cast<int64_t>(P), out,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int pd_sipg_boundary(int dt, int dim, int degree, const void* pts,
                                const void* n, const void* w,
                                const void* h_f, const void* ext,
                                double penalty, int C, int Q, long long P,
                                void* out, void* stream) {
  if (dim < 2 || dim > 3 || degree < 1 || degree > 3) return -1;
  PD_SIPG_DISPATCH(boundary, dt, dim, degree, pts, n, w, h_f, ext, penalty,
                   C, Q, static_cast<int64_t>(P), out,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int pd_sipg_face(int dt, int dim, int degree, const void* pts,
                            const void* n, const void* w, const void* h_f,
                            const void* ext, const void* lo, long long offset,
                            double penalty, int C, int Q, long long P,
                            void* out, void* stream) {
  if (dim < 2 || dim > 3 || degree < 1 || degree > 3) return -1;
  PD_SIPG_DISPATCH(face, dt, dim, degree, pts, n, w, h_f, ext, lo,
                   static_cast<int64_t>(offset), penalty, C, Q,
                   static_cast<int64_t>(P), out,
                   static_cast<cudaStream_t>(stream));
}
