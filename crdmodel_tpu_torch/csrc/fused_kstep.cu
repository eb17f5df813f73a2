// Speculative K-step fused ERK kernel of the 5-point profile operator with
// FitzHugh-Nagumo, Goldbeter or Aliev-Panfilov kinetics (kernel K14 of the
// port).
//
// Replaces crdmodel_tpu/ops/pallas_kstep.py::build_fused_kstep, the Pallas
// TPU kernel that takes K frozen-h steps of an FSAL tableau (bs32, dopri54)
// a launch when a run sets speculative_k. One launch takes K sub-steps of
// one step size h, the last stage of sub-step j serving as the first of
// sub-step j + 1 (FSAL), and writes the state of sub-step n_commit (y
// itself for n_commit = 0) and one partial sum of (err / (rtol |y_j| +
// atol))^2 per K1 tile and sub-step, y_j the sub-step's start.
//
// Design: one persistent cooperative launch (box3d.cuh::launch_cooperative)
// that takes each sub-step in one pass over K1's tiles (ops/fused_step.py::
// tile_plan), with a grid barrier between sub-steps. A pre-pass evaluates
// k_0 = f(y) on every tile; then sub-step j loads y_j and its k_0 on the
// tile and n - 1 rings (3 for bs32, 6 for dopri54), evaluates stages 1 ..
// n - 1 on regions that shrink by one ring each, as a K1 tile does
// (erk_tile.cuh), and writes y_{j+1} and its last stage, the next k_0, on
// the tile to ping-pong buffers in `work`: K grid barriers a launch, y_j
// and k_0 in and out a sub-step. The tile's points are fixed to the
// block's threads (tile_slots.cuh): a point's y and stages live in its
// thread's registers, and only the stage input's variable 0, which the
// stencil reads at neighbours, goes through shared memory (two buffers, so
// one block barrier a stage); stages before the last run at every point of
// the region, so the slots' code has no branches, and a tile inside the
// grid takes code without the wrap. A stage's input at the last stage is the
// update (a[n-1] == b, checked at launch), so y_{j+1} is that input. The
// squared scaled errors of the tile's points pass through shared memory
// so that each partial sum adds them in K1's thread order (store_block_sum
// of erk_tile.cuh), and every stage value, state and partial sum is bitwise
// K1's for the same step; the library is built with -fmad=false, and the
// arithmetic follows the plain version (ops/fused_kstep.py::
// fused_kstep_reference) operation for operation. Indices wrap only where a
// tile's region leaves the grid.
//
// n_commit is read on the device: n_commit < 0 returns at once, and a
// recovery launch (full = 0), which computes only the first n_commit
// sub-steps, copies y for n_commit <= -2 (the adaptive loop's masked
// iterations, integrate/erk.py::integrate_interval_kernel_batched). Block
// 0 counts the launches that did work in counts[full ? 0 : 1].
//
// What bounds it on an H100: a batch must read y and write one state,
// 10.2 MB at 400x1600 in f32, some 3 us at the published 3.35 TB/s; its
// arithmetic, K times a K1 step's less the FSAL evaluation, some 6 us at
// K = 10. Each sub-step moves y_j and k_0 in and out (20 MB at 400x1600,
// within the 50 MB L2) and recomputes the rings' stages; a sub-step waits
// at one grid barrier. No tensor cores, TMA or tuning yet.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "box3d.cuh"
#include "erk_tile.cuh"
#include "rhs_common.cuh"
#include "tile_slots.cuh"

namespace {

using crd::ProfileRhs;
using crd::StageTable;
using crd::TileOrigin;

constexpr int kThreads = 512;                // ops/fused_kstep.py THREADS
// K1's blocks, whose thread order each partial sum follows
constexpr int kSumThreads = crd::kErkThreads;
static_assert(kThreads % kSumThreads == 0, "the sum's threads are warps");
constexpr int kTileX = 32;                   // ops/fused_step.py TILE_X

// The launch's shape: the grid, K1's tiles over it and the batch length.
struct KStepPlan {
  int ny;
  int nx;
  int tiles_x;
  int n_tiles;
  int k;
};

// The region of an NS-stage tableau's tile: K1's tile and NS - 1 rings.
template <int NS, int TileY>
using KRegion = crd::SlotRegion<kTileX + 2 * (NS - 1), TileY + 2 * (NS - 1),
                                kThreads>;

// bs32 in f32, the main path's: two blocks an SM (at most 64 registers)
template <typename T, int NS>
constexpr int kMinBlocks = (sizeof(T) == 4 && NS == 4) ? 2 : 1;

// One partial sum in erk_tile.cuh's order (store_block_sum) to *out, the
// block's threads all taking part, those past K1's block with acc = +0.0
// (exact); warp_sums is free again on return.
template <typename T>
__device__ __forceinline__ void store_tile_sum(T acc, T* warp_sums, T* out) {
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = T(0);
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    *out = total;
  }
  __syncthreads();
}

template <int Kin, typename T, int NS, int TileY>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, NS>))
    fused_kstep_kernel(const T* __restrict__ y, T* __restrict__ y_out,
                       T* __restrict__ ss, T* work,
                       const T* __restrict__ h_ptr,
                       const T* __restrict__ fz_ptr,
                       const int* __restrict__ nc_ptr, int* counts,
                       ProfileRhs<Kin, T> rhs, KStepPlan plan, int full,
                       StageTable tab, T rtol, T atol) {
  using Reg = KRegion<NS, TileY>;
  constexpr int kHalo = NS - 1;
  constexpr int W = Reg::kW;
  constexpr int S = Reg::kSlots;
  constexpr int kTile = kTileX * TileY;
  __shared__ T warp_sums[kThreads / 32];
  // the stage input's variable 0, two guarded planes (tile_slots.cuh)
  __shared__ T su_planes[2][Reg::kStride];
  __shared__ T e2[2][kTile];          // a tile's squared scaled errors
  __shared__ T ha[NS][NS];            // h a[s][i] and h d[i] in T
  __shared__ T hd[NS];
  crd::cg::grid_group grid = crd::cg::this_grid();
  const size_t plane = static_cast<size_t>(plan.ny) * plan.nx;
  const int nc = *nc_ptr;
  const int K = plan.k;

  if (nc < 0 && !(full == 0 && nc <= -2)) return;
  const int commit = nc < 0 ? 0 : min(nc, K);
  const int steps = nc < 0 ? 0 : (full ? K : commit);
  if (nc >= 0 && counts != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(counts + (full ? 0 : 1), 1);
  if (commit == 0) {
    const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x
                         + threadIdx.x;
    const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
    for (size_t g = first; g < 2 * plane; g += stride) y_out[g] = y[g];
  }
  if (steps == 0) return;

  const T h = *h_ptr;
  const T fz = *fz_ptr;
  // each coefficient rounded as a K1 tile rounds it
  if (threadIdx.x < NS * NS) {
    const int s = threadIdx.x / NS, i = threadIdx.x - s * NS;
    ha[s][i] = h * static_cast<T>(tab.a[s][i]);
  }
  if (threadIdx.x < NS)
    hd[threadIdx.x] = h * static_cast<T>(tab.d[threadIdx.x]);
  __syncthreads();
  T* const ybuf = work;               // y_{j+1}: two states in turns
  T* const kbuf = work + 4 * plane;   // k_0: two stage values in turns
  const int tid = threadIdx.x;

  T* const su[2] = {su_planes[0] + Reg::kGuard, su_planes[1] + Reg::kGuard};

  // the pre-pass: k_0 = f(y) on every tile, into kbuf's first slot
  for (int t = blockIdx.x; t < plan.n_tiles; t += gridDim.x) {
    const int ty0 = t / plan.tiles_x;
    const TileOrigin o(ty0 * TileY, (t - ty0 * plan.tiles_x) * kTileX,
                       kHalo, W, Reg::kR, plan.ny, plan.nx);
#pragma unroll
    for (int m = 0; m < S; ++m) {
      const int p = Reg::point(m);
      if (Reg::valid(m) && Reg::inside(p, kHalo - 1))
        su[0][p] = y[o.at<false>(Reg::row(p), Reg::col(p))];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < S; ++m) {
      const int p = Reg::point(m);
      if (!Reg::valid(m) || !Reg::inside(p, kHalo)) continue;
      const int ly = Reg::row(p), lx = Reg::col(p);
      if (!o.in_grid(ly, lx)) continue;
      const size_t g = o.at<false>(ly, lx);
      T du, dv;
      rhs.at(fz, su[0], y[plane + g], p, W, o.row<false>(ly),
             o.col<false>(lx), du, dv);
      kbuf[g] = du;
      kbuf[plane + g] = dv;
    }
    __syncthreads();                  // su is free for the next tile
  }

  for (int j = 0; j < steps; ++j) {
    grid.sync();
    const T* const ycur = j == 0 ? y : ybuf + ((j - 1) & 1) * 2 * plane;
    const T* const kcur = kbuf + (j & 1) * 2 * plane;
    T* const ynext = ybuf + (j & 1) * 2 * plane;
    T* const knext = kbuf + ((j + 1) & 1) * 2 * plane;
    for (int t = blockIdx.x; t < plan.n_tiles; t += gridDim.x) {
      const int ty0 = t / plan.tiles_x;
      const TileOrigin o(ty0 * TileY, (t - ty0 * plan.tiles_x) * kTileX,
                         kHalo, W, Reg::kR, plan.ny, plan.nx);
      // sub-step j on one tile; kIn: its region lies inside the grid
      const auto substep = [&](auto inner) {
        constexpr bool kIn = decltype(inner)::value;
        T yu[S], yv[S];               // y_j at the thread's points
        T ku[NS - 1][S], kv[NS - 1][S];   // k_0 .. k_{n-2} there
#pragma unroll
        for (int m = 0; m < S; ++m) {
          if (!Reg::valid(m)) continue;
          const int p = Reg::point(m);
          const size_t g = o.at<kIn>(Reg::row(p), Reg::col(p));
          yu[m] = ycur[g];
          yv[m] = ycur[plane + g];
          ku[0][m] = kcur[g];
          kv[0][m] = kcur[plane + g];
        }
        // stage s is right on the points s or more rings in; stages
        // before the last run at every point, the values further out
        // unused
#pragma unroll
        for (int s = 1; s < NS; ++s) {
          T* const in = su[s & 1];
          // stage s's input u = y + (h a[s][0]) k_0 + ...
#pragma unroll
          for (int m = 0; m < S; ++m) {
            if (!Reg::valid(m)) continue;
            T u = yu[m];
#pragma unroll
            for (int i = 0; i < s; ++i)
              if (tab.a[s][i] != 0.0) u = u + ha[s][i] * ku[i][m];
            in[Reg::point(m)] = u;
          }
          __syncthreads();
          if (s < NS - 1) {
#pragma unroll
            for (int m = 0; m < S; ++m) {
              if (!Reg::valid(m)) continue;
              const int p = Reg::point(m);
              T v = yv[m];
#pragma unroll
              for (int i = 0; i < s; ++i)
                if (tab.a[s][i] != 0.0) v = v + ha[s][i] * kv[i][m];
              const int ly = Reg::row(p), lx = Reg::col(p);
              rhs.at(fz, in, v, p, W, o.row<kIn>(ly), o.col<kIn>(lx),
                     ku[s][m], kv[s][m]);
            }
            continue;
          }
          // the last stage on the tile, with y_{j+1} (the last stage's
          // input) and the error
#pragma unroll
          for (int m = 0; m < S; ++m) {
            const int p = Reg::point(m);
            if (!Reg::valid(m) || !Reg::inside(p, kHalo)) continue;
            T v = yv[m];
#pragma unroll
            for (int i = 0; i < s; ++i)
              if (tab.a[s][i] != 0.0) v = v + ha[s][i] * kv[i][m];
            const int ly = Reg::row(p), lx = Reg::col(p);
            const int q = (ly - kHalo) * kTileX + lx - kHalo;
            if (!o.in_grid(ly, lx)) {   // adds +0.0: exact, as K1's skip
              e2[0][q] = T(0);
              e2[1][q] = T(0);
              continue;
            }
            T du, dv;
            rhs.at(fz, in, v, p, W, o.row<kIn>(ly), o.col<kIn>(lx), du, dv);
            T eu = T(0), ev = T(0);
#pragma unroll
            for (int i = 0; i < NS - 1; ++i) {
              if (tab.d[i] != 0.0) {
                eu = eu + hd[i] * ku[i][m];
                ev = ev + hd[i] * kv[i][m];
              }
            }
            if (tab.d[NS - 1] != 0.0) {
              eu = eu + hd[NS - 1] * du;
              ev = ev + hd[NS - 1] * dv;
            }
            const size_t g = o.at<kIn>(ly, lx);
            const T nu = in[p];
            ynext[g] = nu;
            ynext[plane + g] = v;
            knext[g] = du;
            knext[plane + g] = dv;
            if (j + 1 == commit) {
              y_out[g] = nu;
              y_out[plane + g] = v;
            }
            const T wu = eu * (T(1) / (rtol * fabs(yu[m]) + atol));
            const T wv = ev * (T(1) / (rtol * fabs(yv[m]) + atol));
            e2[0][q] = wu * wu;
            e2[1][q] = wv * wv;
          }
        }
      };
      if (o.inner)
        substep(std::true_type{});
      else
        substep(std::false_type{});
      __syncthreads();
      T acc = T(0);
      if (tid < kSumThreads) {
        for (int q = tid; q < kTile; q += kSumThreads) {
          acc = acc + e2[0][q];
          acc = acc + e2[1][q];
        }
      }
      store_tile_sum(acc, warp_sums, ss + static_cast<size_t>(t) * K + j);
    }
  }
}

// The tableau is FSAL: its last stage's input is the update (a[n-1] == b),
// so the stage evaluated at the update is the next step's first.
bool is_fsal(int n, const double* a, const double* b) {
  for (int j = 0; j < n; ++j)
    if (a[(n - 1) * n + j] != b[j]) return false;
  return true;
}

// f(kernel, rhs) for the instantiation of (n_stages, tile_y) in T: bs32
// and dopri54 at K1's tiles (ops/fused_kstep.py::kstep_plan); -1 for
// another.
template <int Kin, typename T, class F>
int dispatch_tableau(const crd::RhsConstants<T>& kc, int n_stages,
                     int tile_y, F f) {
  const ProfileRhs<Kin, T> rhs{kc};
  if (n_stages == 4 && tile_y == 32)
    return f(&fused_kstep_kernel<Kin, T, 4, 32>, rhs);
  if constexpr (sizeof(T) == 4) {
    if (n_stages == 7 && tile_y == 32)
      return f(&fused_kstep_kernel<Kin, T, 7, 32>, rhs);
  } else {
    if (n_stages == 7 && tile_y == 16)
      return f(&fused_kstep_kernel<Kin, T, 7, 16>, rhs);
  }
  return -1;
}

template <typename T, class F>
int dispatch(const crd::RhsConstants<T>& kc, int kinetics, int n_stages,
             int tile_y, F f) {
  if (kinetics == crd::kFhn)
    return dispatch_tableau<crd::kFhn, T>(kc, n_stages, tile_y, f);
  if (kinetics == crd::kGoldbeter)
    return dispatch_tableau<crd::kGoldbeter, T>(kc, n_stages, tile_y, f);
  if (kinetics == crd::kAlievPanfilov)
    return dispatch_tableau<crd::kAlievPanfilov, T>(kc, n_stages, tile_y,
                                                    f);
  return -1;
}

template <typename T>
int launch(const void* y, void* y_out, void* ss, void* work, const void* h,
           const void* fz, const void* n_commit, void* counts, int full,
           int k, const void* c0, const void* c1, const void* c2, int torus,
           const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int ny, int nx, int tile_y,
           int n_stages, const double* a, const double* b, const double* d,
           double rtol, double atol, void* stream) {
  StageTable tab;
  if (n_stages < 2 || !crd::make_stage_table(n_stages, a, b, d, &tab)
      || !is_fsal(n_stages, a, b) || k < 1 || ny < 1 || nx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::RhsConstants<T> kc = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const int tiles_x = (nx + kTileX - 1) / kTileX;
  KStepPlan plan = {ny, nx, tiles_x, tiles_x * ((ny + tile_y - 1) / tile_y),
                    k};
  const T* y_arg = static_cast<const T*>(y);
  T* yout_arg = static_cast<T*>(y_out);
  T* ss_arg = static_cast<T*>(ss);
  T* work_arg = static_cast<T*>(work);
  const T* h_arg = static_cast<const T*>(h);
  const T* fz_arg = static_cast<const T*>(fz);
  const int* nc_arg = static_cast<const int*>(n_commit);
  int* counts_arg = static_cast<int*>(counts);
  T rtol_arg = static_cast<T>(rtol), atol_arg = static_cast<T>(atol);
  int n_blocks = 0;
  const size_t n_points = static_cast<size_t>(plan.n_tiles) * kThreads;
  const auto go = [&](auto kernel, auto rhs) {
    void* args[] = {&y_arg, &yout_arg, &ss_arg, &work_arg, &h_arg, &fz_arg,
                    &nc_arg, &counts_arg, &rhs, &plan, &full, &tab,
                    &rtol_arg, &atol_arg};
    return crd::launch_cooperative(kernel, n_points, plan.n_tiles,
                                   &n_blocks, args, stream, 0, kThreads);
  };
  const int rc = dispatch<T>(kc, kinetics, n_stages, tile_y, go);
  return rc < 0 ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

// out[0] the resident blocks an SM, out[1] the registers a thread, out[2]
// the static shared bytes a block of the kernel of (kinetics, n_stages,
// tile_y) in T; returns the CUDA error code.
template <typename T>
int info(int kinetics, int n_stages, int tile_y, int* out) {
  const auto query = [&](auto kernel, auto) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                          kThreads, 0);
    out[1] = attr.numRegs;
    out[2] = static_cast<int>(attr.sharedSizeBytes);
    return static_cast<int>(err);
  };
  const int rc = dispatch<T>(crd::RhsConstants<T>{}, kinetics, n_stages,
                             tile_y, query);
  return rc < 0 ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

}  // namespace

#define CRD_FUSED_KSTEP_ARGS                                                 \
  const void *y, void *y_out, void *ss, void *work, const void *h,          \
      const void *fz, const void *n_commit, void *counts, int full, int k,  \
      const void *c0, const void *c1, const void *c2, int torus,            \
      const void *beta, int beta_field, const void *mask, int has_freeze,   \
      int kinetics, int ny, int nx, int tile_y, int n_stages,               \
      const double *a, const double *b, const double *d, double rtol,       \
      double atol, void *stream
#define CRD_FUSED_KSTEP_PASS                                                 \
  y, y_out, ss, work, h, fz, n_commit, counts, full, k, c0, c1, c2, torus,  \
      beta, beta_field, mask, has_freeze, kinetics, ny, nx, tile_y,         \
      n_stages, a, b, d, rtol, atol, stream

extern "C" int crd_fused_kstep_f32(CRD_FUSED_KSTEP_ARGS) {
  return launch<float>(CRD_FUSED_KSTEP_PASS);
}

extern "C" int crd_fused_kstep_f64(CRD_FUSED_KSTEP_ARGS) {
  return launch<double>(CRD_FUSED_KSTEP_PASS);
}

extern "C" int crd_fused_kstep_info(int f64, int kinetics, int n_stages,
                                    int tile_y, int* out) {
  return f64 ? info<double>(kinetics, n_stages, tile_y, out)
             : info<float>(kinetics, n_stages, tile_y, out);
}
