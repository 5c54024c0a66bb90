// K1 and K2 at any block size nb, for Hopper (sm_90a): the build that
// PD_NB_DISPATCH (csrc/banded_common.cuh) takes for an nb without a
// specialised one (KERNEL_NB = 3, 4, 6, 10, 20: csrc/banded_matvec.cu and
// csrc/banded.cu), with nb a runtime argument.  TensorDGQ's blocks (4, 9,
// 16 in 2D; 8, 27, 64 in 3D), P_k's beyond p = 3 (15, 21 in 2D; 35 in 3D)
// and the field blocks of the coupled models (12, 30, ...) run here.
//
// Replaces the TPU Pallas kernels, at those nb,
//   K1  polydeal_tpu/ops/banded.py      _banded_matvec_imajor_impl
//   K2  polydeal_tpu/ops/fused_cheb.py  _banded_fused_impl
// and their sharded entries (banded_matvec_t_halo, banded_cheb_step_t_halo,
// banded_residual_t_halo) on one shard's lane slab: x is x_ext [nb, ldx]
// read at column halo + p + off, as in the specialised builds.
//
//   y[i,p] = sum_k sum_j data_i[i*R_pad + k*nb + j, p] * x[j, p+off_k]
// then, for K2, the Chebyshev step or the residual on y, pointwise in
// (i, p) (modes as in csrc/banded.cu).
//
// What bounds it: memory, as the specialised builds (the band is read
// once, two flops an element).  The specialised kernels keep all nb rows
// of a lane in registers; at runtime nb a thread keeps a chunk of R output
// rows of W adjacent lanes (acc[R][W] in registers).  The card needs many
// band loads in flight to reach its memory rate, and the shapes differ by
// two orders in lanes (a 4-way cut's 8192-lane slab to 262144 lanes) and
// by 4x in element size.  For each offset k a thread walks j in batches of
// JB columns: the R JB band segments of a batch (16-byte streaming loads,
// 8 of them, 128 bytes) are all issued before the first is used, then the
// batch's x windows (at most 64 bytes); a row past nb in the last chunk
// re-reads the chunk's last row (the load stays unconditional) and is
// never stored; the columns left after the whole batches go in batches of
// JB / 2, ..., 1.  The launch plan chooses, from nb, n_off, P and the
// types (plan_of):
//   * R, rows a thread: 4 for the type pairs with a bf16 band or f64
//     vectors; for an f32 band with f32 vectors 8 where that still leaves
//     the launch kManyThreads threads (most whole bands), else 2; at most
//     nb;
//   * S, offset groups: where the launch has fewer than kFillThreads
//     threads (P / W lanes-threads times the nb / R row chunks, the
//     8192-lane slabs of a 4-way cut), S threads of a block take
//     contiguous ranges of the offsets k for the same rows and lanes, up
//     to 4, and their partial sums meet in shared memory, added in group
//     order (no atomics);
//   * CB, row chunks a block: 2 where there are two, so that the x window
//     x[j, p + off_k .. + W) that one chunk loads is found in L1 by the
//     other (x is read once a chunk, nb / R times, and the band once).
// These rules were chosen by timing every (R, S, CB), JB, blocks of 128
// and 256 threads and a two-block register cap on the card at the paths'
// shapes (nb 8, 15, 21, 27, 35; whole bands of 32768-262144 lanes and
// 4-way slabs; f32, bf16 and f64 bands): they read within ~6% of the best
// of those plans at every shape (PERF.md).  W follows K2's rule: wide where P, ldx and halo are
// multiples of it, every operand is 16-byte aligned, else one lane a
// thread; the R W accumulators stay within 384 bytes.  Each row sums over
// k, then j, in order (within an offset group, then the groups in order):
// two launches give the same bits, and with S = 1 the order is the plain
// loop's.  Accumulation runs in the vector type (f64 for an f64 solve).
// Row offsets use 64-bit arithmetic.  The plan (W, R, S, CB, block, grid,
// shared bytes) comes from one function, plan_of, which the launch runs
// and the C entry pd_banded_matvec_plan reports; ops/banded.any_nb_plan
// is its pure Python statement, which the CPU tests check.
//
// Reached only through the C entries of csrc/banded_matvec.cu (K1, K1
// halo, K1's plan) and csrc/banded.cu (K2, K2 halo).

#include "banded_common.cuh"

namespace {

// the modes of the C interface (csrc/banded.cu's enum Mode), PRODUCT being
// K1's plain y = A x
enum Mode { RESIDUAL = 0, STEP0 = 1, STEP = 2, PRODUCT = 3 };

constexpr int kThreads = 256;  // threads a block
constexpr int kMaxGroups = 4;  // offset groups S
// a launch with fewer threads than this takes offset groups
constexpr int64_t kFillThreads = 32768;
// an f32 band with f32 vectors takes 8 rows a thread where that leaves
// the launch this many threads
constexpr int64_t kManyThreads = 40960;

// f32 band and f32 vectors: the one pair that takes 8 rows a thread
template <typename TD, typename TV>
constexpr bool f32_pair() {
  return sizeof(TD) == 4 && sizeof(TV) == 4;
}

// columns j a batch: 8 / R (4 at most), so that a batch holds R JB <= 8
// band loads, halved while its JB x windows would outgrow 64 bytes
template <typename TD, typename TV, int R, int W>
__host__ __device__ constexpr int any_batch() {
  int jb = 8 / R < 4 ? 8 / R : 4;
  while (jb > 1 && jb * W * static_cast<int>(sizeof(TV)) > 64) jb /= 2;
  return jb;
}

struct Plan {
  int W;            // lanes a thread
  int R;            // rows a thread (a row chunk)
  int S;            // offset groups a block
  int CB;           // row chunks a block
  int threads;      // threads a block
  unsigned gx, gy;  // grid: lane tiles x blocks of row chunks
  size_t smem;      // bytes of the groups' partial sums
};

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename TD, typename TV>
int wide_of(int R) {
  switch (R) {
    case 8: return wide_lanes<TD, TV, 8>();
    case 4: return wide_lanes<TD, TV, 4>();
    case 2: return wide_lanes<TD, TV, 2>();
    default: return wide_lanes<TD, TV, 1>();
  }
}

// The plan of one launch (see the header).  ``aligned``: every operand
// 16-byte aligned.
template <typename TD, typename TV>
Plan plan_of(int nb, int n_off, int64_t P, int64_t ldx, int64_t halo,
             bool aligned) {
  Plan pl;
  const auto lanes_w = [&](int R) {
    const int w = wide_of<TD, TV>(R);
    return w > 1 && aligned && P % w == 0 && ldx % w == 0 && halo % w == 0
               ? w
               : 1;
  };
  pl.R = f32_pair<TD, TV>() ? 2 : 4;
  if (f32_pair<TD, TV>() && nb >= 8 &&
      cdiv(P, lanes_w(8)) * cdiv(nb, 8) >= kManyThreads) {
    pl.R = 8;
  }
  while (pl.R > nb) pl.R /= 2;
  pl.W = lanes_w(pl.R);
  const int64_t lanes = cdiv(P, pl.W);  // lanes-threads
  const int64_t chunks = cdiv(nb, pl.R);
  pl.S = 1;
  while (pl.S < kMaxGroups && 2 * pl.S <= n_off &&
         lanes * chunks * pl.S < kFillThreads) {
    pl.S *= 2;
  }
  pl.CB = chunks >= 2 ? 2 : 1;
  pl.threads = kThreads;
  const int Lt = kThreads / (pl.CB * pl.S);
  pl.gx = static_cast<unsigned>(cdiv(lanes, Lt));
  pl.gy = static_cast<unsigned>(cdiv(chunks, pl.CB));
  // groups 1..S-1's partial sums: at most 3/4 of 256 threads' R W
  // values, R W sizeof(TV) <= 256 bytes (bf16 band, f64 vectors): 48 KB,
  // the shared memory a block takes without opting in
  pl.smem = static_cast<size_t>(kThreads) * (pl.S - 1) / pl.S * pl.R *
            pl.W * sizeof(TV);
  return pl;
}

// x[j, q0 .. q0 + W) of the rows j a batch reads: wide where the window is
// aligned (wholly inside or outside [0, ldx)), else lane by lane
template <typename TV, int W>
__device__ __forceinline__ void x_window(const TV* __restrict__ xr,
                                         int64_t q0, int64_t ldx, bool x_al,
                                         bool x_in, TV (&xv)[W]) {
  if (x_al) {
    if (x_in) {
      load_wide<false, W>(xr, xv);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) xv[w] = TV(0);
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int64_t q = q0 + w;
      xv[w] = q >= 0 && q < ldx ? __ldg(xr + w) : TV(0);
    }
  }
}

// acc[r][w] += sum over j in [j, j_end), in order, of band row (r, k, j) at
// a (rows r past ``rows`` read row rows - 1) times x[j, q0 + w]: whole
// batches of JB columns, then the rest in batches of JB / 2, ..., 1
template <typename TD, typename TV, int R, int W, int JB>
__device__ __forceinline__ void batches(const TD* __restrict__ a,
                                        int64_t rs, int rows,
                                        const TV* __restrict__ xr,
                                        int64_t q0, int64_t ldx, int64_t P,
                                        int j, int j_end, bool x_al,
                                        bool x_in, TV (&acc)[R][W]) {
  for (; j + JB <= j_end; j += JB) {
    TD v[JB][R][W];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int rr = r < rows ? r : rows - 1;
        load_wide<true, W>(a + rr * rs + static_cast<int64_t>(j + jj) * P,
                           v[jj][r]);
      }
    }
    TV xv[JB][W];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      x_window<TV, W>(xr + static_cast<int64_t>(j + jj) * ldx, q0, ldx, x_al,
                      x_in, xv[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          acc[r][w] += as<TV>(v[jj][r][w]) * xv[jj][w];
        }
      }
    }
  }
  if constexpr (JB > 1) {
    batches<TD, TV, R, W, JB / 2>(a, rs, rows, xr, q0, ldx, P, j, j_end,
                                  x_al, x_in, acc);
  }
}

// Thread t of a block: lane-thread l = t % Lt, slot t / Lt = cb S + s (row
// chunk cb of the block's CB, offset group s), Lt = threads / (CB S).
// Every thread passes the barrier: threads past P or nb carry zeros.
template <typename TD, typename TV, int R, int W>
__global__ void __launch_bounds__(kThreads)
    any_nb_kernel(const TD* __restrict__ data, const TV* __restrict__ x,
                  const int* __restrict__ offsets, int n_off, int nb,
                  int R_pad, int64_t P, int64_t ldx, int64_t halo, int S,
                  int CB, const TV* __restrict__ b, const TV* __restrict__ d,
                  const TV* __restrict__ dinv, double c1, double c2,
                  int mode, TV* __restrict__ out0, TV* __restrict__ out1) {
  constexpr int JB = any_batch<TD, TV, R, W>();
  extern __shared__ __align__(16) unsigned char any_smem[];
  const int Lt = blockDim.x / (CB * S);
  const int l = threadIdx.x % Lt;
  const int slot = threadIdx.x / Lt;
  const int s = slot % S;
  const int i0 = (static_cast<int>(blockIdx.y) * CB + slot / S) * R;
  const int rows = nb - i0 < R ? nb - i0 : R;
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * Lt + l) * W;
  const bool live = p0 < P && rows > 0;
  TV acc[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int w = 0; w < W; ++w) acc[r][w] = TV(0);
  }
  if (live) {
    const int64_t rs = static_cast<int64_t>(R_pad) * P;  // a row's stride
    const TD* base = data + static_cast<int64_t>(i0) * rs + p0;
    for (int k = s * n_off / S; k < (s + 1) * n_off / S; ++k) {
      const int off = __ldg(offsets + k);
      const int64_t q0 = halo + p0 + off;  // x's column of lane p0
      // with ldx % W == 0 a window at a multiple of W lies wholly inside
      // or wholly outside [0, ldx)
      batches<TD, TV, R, W, JB>(base + static_cast<int64_t>(k) * nb * P, rs,
                                rows, x + q0, q0, ldx, P, 0, nb, off % W == 0,
                                q0 >= 0 && q0 < ldx, acc);
    }
  }
  if (S > 1) {
    // groups 1..S-1 leave their sums, [S - 1][CB][R][W][Lt], lanes
    // innermost; group 0 adds them in group order
    TV* part = reinterpret_cast<TV*>(any_smem);
    const int cb = slot / S;
    const auto at = [&](int g, int r, int w) {
      return ((((g - 1) * CB + cb) * R + r) * W + w) * Lt + l;
    };
    if (s > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int w = 0; w < W; ++w) part[at(s, r, w)] = acc[r][w];
      }
    }
    __syncthreads();
    if (s > 0) return;
    for (int g = 1; g < S; ++g) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int w = 0; w < W; ++w) acc[r][w] += part[at(g, r, w)];
      }
    }
  }
  if (!live) return;
  // the recurrence scalars act in the vector type, as in the plain version
  const TV c1v = static_cast<TV>(c1);
  const TV c2v = static_cast<TV>(c2);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) break;
    const int i = i0 + r;
    const int64_t idx = static_cast<int64_t>(i) * P + p0;
    if (mode == PRODUCT) {
      store_wide<W>(out0 + idx, acc[r]);
      continue;
    }
    TV bv[W];
    load_wide<false, W>(b + idx, bv);
    if (mode == RESIDUAL) {
#pragma unroll
      for (int w = 0; w < W; ++w) bv[w] -= acc[r][w];
      store_wide<W>(out0 + idx, bv);
      continue;
    }
    TV dv[W], iv[W], xn[W], dn[W];
    load_wide<false, W>(dinv + idx, iv);
    // the update's own x sits at column halo + p0 of x's row i
    load_wide<false, W>(x + static_cast<int64_t>(i) * ldx + halo + p0, xn);
    if (mode == STEP) load_wide<false, W>(d + idx, dv);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      dn[w] = c2v * (iv[w] * (bv[w] - acc[r][w]));
      if (mode == STEP) dn[w] = c1v * dv[w] + dn[w];
      xn[w] += dn[w];
    }
    store_wide<W>(out0 + idx, xn);
    store_wide<W>(out1 + idx, dn);
  }
}

template <typename TD, typename TV, int R>
int launch_r(const Plan& pl, const void* data, const void* x,
             const int* offsets, int n_off, int nb, int R_pad, int64_t P,
             int64_t ldx, int64_t halo, const void* b, const void* d,
             const void* dinv, double c1, double c2, int mode, void* out0,
             void* out1, cudaStream_t st) {
  constexpr int kWide = wide_lanes<TD, TV, R>();
  decltype(&any_nb_kernel<TD, TV, R, 1>) kernel =
      pl.W == kWide ? &any_nb_kernel<TD, TV, R, kWide>
                    : &any_nb_kernel<TD, TV, R, 1>;
  kernel<<<dim3(pl.gx, pl.gy), pl.threads, pl.smem, st>>>(
      static_cast<const TD*>(data), static_cast<const TV*>(x), offsets,
      n_off, nb, R_pad, P, ldx, halo, pl.S, pl.CB, static_cast<const TV*>(b),
      static_cast<const TV*>(d), static_cast<const TV*>(dinv), c1, c2, mode,
      static_cast<TV*>(out0), static_cast<TV*>(out1));
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TV>
int launch(int nb, const void* data, const void* x, const int* offsets,
           int n_off, int R_pad, int64_t P, int64_t ldx, int64_t halo,
           const void* b, const void* d, const void* dinv, double c1,
           double c2, int mode, void* out0, void* out1, cudaStream_t st) {
  auto ok = [](const void* p) { return p == nullptr || aligned16(p); };
  const Plan pl =
      plan_of<TD, TV>(nb, n_off, P, ldx, halo,
                      aligned16(data) && aligned16(x) && ok(b) && ok(d) &&
                          ok(dinv) && ok(out0) && ok(out1));
  if (P <= 0) return static_cast<int>(cudaGetLastError());
  if constexpr (f32_pair<TD, TV>()) {
    if (pl.R == 8) {
      return launch_r<TD, TV, 8>(pl, data, x, offsets, n_off, nb, R_pad, P,
                                 ldx, halo, b, d, dinv, c1, c2, mode, out0,
                                 out1, st);
    }
  }
  switch (pl.R) {
    case 4:
      return launch_r<TD, TV, 4>(pl, data, x, offsets, n_off, nb, R_pad, P,
                                 ldx, halo, b, d, dinv, c1, c2, mode, out0,
                                 out1, st);
    case 2:
      return launch_r<TD, TV, 2>(pl, data, x, offsets, n_off, nb, R_pad, P,
                                 ldx, halo, b, d, dinv, c1, c2, mode, out0,
                                 out1, st);
    default:
      return launch_r<TD, TV, 1>(pl, data, x, offsets, n_off, nb, R_pad, P,
                                 ldx, halo, b, d, dinv, c1, c2, mode, out0,
                                 out1, st);
  }
}

}  // namespace

namespace pd_any_nb {

template <typename TD, typename TV>
int matvec(int nb, const void* data, const void* x, const int* offsets,
           int n_off, int R_pad, int64_t P, int64_t ldx, int64_t halo,
           void* y, cudaStream_t st) {
  return launch<TD, TV>(nb, data, x, offsets, n_off, R_pad, P, ldx, halo,
                        nullptr, nullptr, nullptr, 0.0, 0.0, PRODUCT, y,
                        nullptr, st);
}

template <typename TD, typename TV>
int fused(int nb, const void* data, const void* x, const int* offsets,
          int n_off, int R_pad, int64_t P, int64_t ldx, int64_t halo,
          const void* b, const void* d, const void* dinv, double c1,
          double c2, int mode, void* out0, void* out1, cudaStream_t st) {
  return launch<TD, TV>(nb, data, x, offsets, n_off, R_pad, P, ldx, halo, b,
                        d, dinv, c1, c2, mode, out0, out1, st);
}

template <typename TD, typename TV>
int plan(int nb, const void* data, const void* x, const void* y, int n_off,
         int64_t P, int64_t ldx, int64_t halo, long long* out) {
  const Plan pl = plan_of<TD, TV>(
      nb, n_off, P, ldx, halo,
      aligned16(data) && aligned16(x) && (y == nullptr || aligned16(y)));
  out[0] = pl.W;
  out[1] = pl.S;
  out[2] = pl.threads;
  out[3] = static_cast<long long>(pl.gx) * pl.gy;
  out[4] = static_cast<long long>(pl.smem);
  out[5] = pl.R;
  out[6] = pl.CB;
  return 0;
}

#define PD_ANY_NB_INSTANCE(TD, TV)                                          \
  template int matvec<TD, TV>(int, const void*, const void*, const int*,    \
                              int, int, int64_t, int64_t, int64_t, void*,   \
                              cudaStream_t);                                \
  template int fused<TD, TV>(int, const void*, const void*, const int*, int, \
                             int, int64_t, int64_t, int64_t, const void*,   \
                             const void*, const void*, double, double, int, \
                             void*, void*, cudaStream_t);                   \
  template int plan<TD, TV>(int, const void*, const void*, const void*, int, \
                            int64_t, int64_t, int64_t, long long*);

// the (data, vector) dtype pairs of PD_DISPATCH
PD_ANY_NB_INSTANCE(float, float)
PD_ANY_NB_INSTANCE(__nv_bfloat16, float)
PD_ANY_NB_INSTANCE(double, double)
PD_ANY_NB_INSTANCE(float, double)
PD_ANY_NB_INSTANCE(__nv_bfloat16, double)

#undef PD_ANY_NB_INSTANCE

}  // namespace pd_any_nb
