// Banded block SpMV (K1) for Hopper (sm_90a), over the i-major band layout
// of BlockBanded.data_i (csrc/banded_common.cuh), and its halo entry.
//
// Replaces the TPU Pallas kernel
//   K1  polydeal_tpu/ops/banded.py  _banded_matvec_imajor_impl
// and, through pd_banded_matvec_halo, the sharded entry point
//   polydeal_tpu/ops/banded.py  banded_matvec_t_halo
// on one shard's lane slab: x is x_ext [nb, ldx = P + 2 T] whose T lanes on
// each side are the neighbouring shards' (every |off| <= T), lane p reading
// column T + p + off.  x's row stride ldx and the halo width are runtime
// arguments (the unsharded entry passes ldx = P, halo = 0), so the halo
// adds no template instantiation.
//
//   y[i,p] = sum_k sum_j data_i[i*R_pad + k*nb + j, p] * x[j, p+off_k],
//   x zero outside [0, P) (outside x's ldx columns for a slab).
//
// What bounds it: memory.  A call streams the band once, nb*n_off*nb*P
// elements (65 MB in f32 on the COO Poisson's 32768-lane 31-offset level,
// 1.24 GB in f64 on its 262144-lane 37-offset one), against two flops an
// element.  Each thread owns W adjacent lanes and all nb output rows and
// runs K2's register-blocked product loop (band_accumulate): one 16-byte
// streaming load moves a band row segment, a batch of them is in flight
// before the first is used, and each x window is loaded once a thread.
// W follows K2's rule: wide where P, ldx and halo are multiples of it and
// every operand is 16-byte aligned, else one lane a thread.
//
// Where P / W threads leave the card short of loads in flight (the
// 32768-lane levels, the lane slabs of a 4-way cut), S warp groups of a
// block take contiguous ranges of the offsets for the same lanes: group s
// sums k in [s*n_off/S, (s+1)*n_off/S).  Groups 1..S-1 leave their partial
// sums in shared memory and group 0 adds them to its own in group order,
// then stores y: no atomics, so two launches give the same bits.  Within a
// group each row sums over k, then j; with S = 1 that is the order of the
// plain loop over k and j.  The plan (W, S, block, grid, shared bytes)
// comes from one function, k1_plan, which the launch runs and
// pd_banded_matvec_plan reports.  Accumulation runs in the vector type
// (f64 for an f64 solve).  Row offsets use 64-bit arithmetic.  The TPU
// mechanics (lane tiles, funnel shifts, padded x and pre-rolled far
// copies, SMEM scalars) have no counterpart.
//
// Plain C interface for ctypes (built by polydeal_tpu_torch/ops/_build.py):
// each entry point launches on the given stream and returns
// cudaGetLastError() (0 on success), -1 for an unsupported dtype pair or
// -4 for nb < 1.  At an nb without a specialised build (banded_common.cuh's
// PD_NB_DISPATCH) K1, K1 halo and the plan are csrc/banded_any_nb.cu's.

#include "banded_common.cuh"

namespace {

constexpr int kThreads = 256;  // a block: S groups of kThreads / S threads
constexpr int kMaxGroups = 8;  // S <= 8: a group is at least one warp
// S doubles while P / W threads times S stay under this (~16 warps an SM
// over 132 SMs) ...
constexpr int64_t kFillThreads = 65536;
// ... and the partial sums of groups 1..S-1 fit the default shared memory
constexpr size_t kMaxSmem = 48 * 1024;

struct Plan {
  int W;            // lanes a thread
  int S;            // offset groups a block
  int threads;      // threads a block
  unsigned blocks;  // blocks
  size_t smem;      // bytes of partial sums
};

template <typename TD, typename TV, int NB>
Plan k1_plan(const void* data, const void* x, const void* y, int n_off,
             int64_t P, int64_t ldx, int64_t halo) {
  constexpr int kWide = wide_lanes<TD, TV, NB>();
  const bool wide = kWide > 1 && P % kWide == 0 && ldx % kWide == 0 &&
                    halo % kWide == 0 && aligned16(data) && aligned16(x) &&
                    aligned16(y);
  Plan pl;
  pl.W = wide ? kWide : 1;
  const int64_t lanes = (P + pl.W - 1) / pl.W;  // threads of one group
  auto smem = [&](int s) {
    return static_cast<size_t>(s - 1) * NB * pl.W * (kThreads / s) *
           sizeof(TV);
  };
  pl.S = 1;
  while (pl.S < kMaxGroups && 2 * pl.S <= n_off &&
         lanes * pl.S < kFillThreads && smem(2 * pl.S) <= kMaxSmem) {
    pl.S *= 2;
  }
  pl.threads = kThreads;
  pl.blocks = n_blocks(lanes, kThreads / pl.S);
  pl.smem = smem(pl.S);
  return pl;
}

template <typename TD, typename TV, int NB, int W>
__global__ void __launch_bounds__(kThreads)
    banded_matvec_imajor_kernel(const TD* __restrict__ data,
                                const TV* __restrict__ x,
                                const int* __restrict__ offsets, int n_off,
                                int R_pad, int64_t P, int64_t ldx,
                                int64_t halo, int S, TV* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  const int L = blockDim.x / S;  // lanes-threads of a group (whole warps)
  const int s = threadIdx.x / L;
  const int l = threadIdx.x - s * L;
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * L + l) * W;
  const bool live = p0 < P;
  TV acc[NB][W];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
#pragma unroll
    for (int w = 0; w < W; ++w) acc[i][w] = TV(0);
  }
  if (live) {
    band_accumulate<TD, TV, NB, W>(data, x, offsets, s * n_off / S,
                                   (s + 1) * n_off / S, R_pad, P, ldx, halo,
                                   p0, acc);
  }
  if (S > 1) {
    // groups 1..S-1 leave their sums, [S - 1][NB][W][L], lanes innermost
    TV* part = reinterpret_cast<TV*>(k1_smem);
    if (s > 0) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          part[((s - 1) * NB * W + i * W + w) * L + l] = acc[i][w];
        }
      }
    }
    __syncthreads();
    if (s > 0) return;
    for (int r = 1; r < S; ++r) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          acc[i][w] += part[((r - 1) * NB * W + i * W + w) * L + l];
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    store_wide<W>(y + static_cast<int64_t>(i) * P + p0, acc[i]);
  }
}

template <typename TD, typename TV, int NB>
int launch_matvec_nb(const void* data, const void* x, const int* offsets,
                     int n_off, int R_pad, int64_t P, int64_t ldx,
                     int64_t halo, void* y, cudaStream_t st) {
  constexpr int kWide = wide_lanes<TD, TV, NB>();
  const Plan pl = k1_plan<TD, TV, NB>(data, x, y, n_off, P, ldx, halo);
  decltype(&banded_matvec_imajor_kernel<TD, TV, NB, 1>) kernel =
      pl.W == kWide ? &banded_matvec_imajor_kernel<TD, TV, NB, kWide>
                    : &banded_matvec_imajor_kernel<TD, TV, NB, 1>;
  kernel<<<pl.blocks, pl.threads, pl.smem, st>>>(
      static_cast<const TD*>(data), static_cast<const TV*>(x), offsets,
      n_off, R_pad, P, ldx, halo, pl.S, static_cast<TV*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename TD, typename TV>
int launch_matvec(const void* data, const void* x, const int* offsets,
                  int n_off, int nb, int R_pad, int64_t P, int64_t ldx,
                  int64_t halo, void* y, cudaStream_t st) {
  if (nb < 1) return -4;
  PD_NB_DISPATCH(launch_matvec_nb, pd_any_nb::matvec, TD, TV, nb, data, x,
                 offsets, n_off, R_pad, P, ldx, halo, y, st);
}

template <typename TD, typename TV, int NB>
int plan_nb(const void* data, const void* x, const void* y, int n_off,
            int64_t P, int64_t ldx, int64_t halo, long long* out) {
  const Plan pl = k1_plan<TD, TV, NB>(data, x, y, n_off, P, ldx, halo);
  out[0] = pl.W;
  out[1] = pl.S;
  out[2] = pl.threads;
  out[3] = pl.blocks;
  out[4] = static_cast<long long>(pl.smem);
  out[5] = NB;  // rows a thread: all of a lane's
  out[6] = 1;   // row chunks a block: the one
  return 0;
}

template <typename TD, typename TV>
int plan_of(const void* data, const void* x, const void* y, int n_off,
            int nb, int64_t P, int64_t ldx, int64_t halo, long long* out) {
  if (nb < 1) return -4;
  PD_NB_DISPATCH(plan_nb, pd_any_nb::plan, TD, TV, nb, data, x, y, n_off, P,
                 ldx, halo, out);
}

}  // namespace

extern "C" int pd_banded_matvec(const void* data, int data_dt, const void* x,
                                int vec_dt, const int* offsets, int n_off,
                                int nb, int R_pad, long long P, void* y,
                                void* stream) {
  PD_DISPATCH(launch_matvec, data_dt, vec_dt, data, x, offsets, n_off, nb,
              R_pad, static_cast<int64_t>(P), static_cast<int64_t>(P), 0, y,
              static_cast<cudaStream_t>(stream));
}

// K1 on a shard's slab, x_ext [nb, ldx] with ldx = P + 2 halo, lane p
// reading column halo + p + off.
extern "C" int pd_banded_matvec_halo(const void* data, int data_dt,
                                     const void* x, int vec_dt,
                                     const int* offsets, int n_off, int nb,
                                     int R_pad, long long P, long long ldx,
                                     long long halo, void* y, void* stream) {
  PD_DISPATCH(launch_matvec, data_dt, vec_dt, data, x, offsets, n_off, nb,
              R_pad, static_cast<int64_t>(P), static_cast<int64_t>(ldx),
              static_cast<int64_t>(halo), y,
              static_cast<cudaStream_t>(stream));
}

// The plan a launch with these arguments takes (y may be null: a fresh
// output, 16-byte aligned): plan[0..6] = W, S, threads a block, blocks,
// bytes of shared memory, output rows a thread, row chunks a block.
// Launches nothing.
extern "C" int pd_banded_matvec_plan(const void* data, int data_dt,
                                     const void* x, int vec_dt, int n_off,
                                     int nb, long long P, long long ldx,
                                     long long halo, const void* y,
                                     long long* plan) {
  PD_DISPATCH(plan_of, data_dt, vec_dt, data, x, y, n_off, nb,
              static_cast<int64_t>(P), static_cast<int64_t>(ldx),
              static_cast<int64_t>(halo), plan);
}
