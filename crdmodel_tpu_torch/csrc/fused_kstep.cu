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
// Design: the TPU kernel keeps a row strip in VMEM with a halo of one ring
// a RHS evaluation, 1 + 3K rings for bs32; at K = 10 a 32x32 tile would
// need some 94x94 points of a dozen stage arrays, more than an SM's shared
// memory. This kernel is instead one persistent cooperative launch
// (box3d.cuh::launch_cooperative, as K6): the sub-steps' states and the
// stage values live in device memory, and a grid barrier follows each RHS
// evaluation, 1 + (s - 1) K of them for an s-stage tableau. A pass
// evaluates stage s at every point: a block forms the stage input y_j +
// sum (h a[s][i]) k_i of its tile and one ring in shared memory (the wrap
// is WrapGrid's modular index), then calls the shared functor
// crd::ProfileRhs there, as a K1 tile does. The last stage's pass also
// forms y_{j+1} and the error, so each sub-step takes s - 1 passes. The
// points are walked in K1's tiles (fused_step.cu, erk_tile.cuh), each tile
// by one block in K1's thread order, so that every stage value, state and
// partial sum is bitwise K1's for the same step; the library is built with
// -fmad=false, and the arithmetic follows the plain version
// (ops/fused_kstep.py::fused_kstep_reference) operation for operation.
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
// K = 10. Each pass instead moves some three states through the L2 and
// device memory and waits at a grid barrier. No tensor cores, TMA or
// tuning yet.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "box3d.cuh"
#include "erk_tile.cuh"
#include "rhs_common.cuh"

namespace {

using crd::ProfileRhs;
using crd::StageTable;
using crd::WrapGrid;

constexpr int kThreads = crd::kBoxThreads;   // launch_cooperative's blocks
constexpr int kTileX = 32;                   // ops/fused_step.py TILE_X

// The launch's shape: the grid, K1's tiles over it and the batch length.
struct KStepPlan {
  int ny;
  int nx;
  int tile_y;
  int tiles_x;
  int n_tiles;
  int k;
};

constexpr int kMaxTileY = 32;                // ops/fused_step.py tile_plan
// the stage input's region: a tile and one ring, both variables
constexpr int kRegion = (kTileX + 2) * (kMaxTileY + 2);

// The stage-s input at flat point g of one variable: y + (h a[s][0]) k_0
// + ..., the ERK tile kernels' order; kp[i] is k_i's plane of the variable.
template <typename T>
__device__ __forceinline__ T stage_input(const StageTable& tab, int s, T h,
                                         const T* y, T* const* kp, size_t g) {
  T u = y[g];
#pragma unroll
  for (int i = 0; i < crd::kErkMaxStages; ++i) {
    if (i >= s) break;
    if (tab.a[s][i] != 0.0) {
      const T ha = h * static_cast<T>(tab.a[s][i]);
      u = u + ha * kp[i][g];
    }
  }
  return u;
}

// One partial sum in erk_tile.cuh's order (store_block_sum) to *out, the
// block's threads all taking part; warp_sums is free again on return.
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

template <int Kin, typename T>
__global__ void __launch_bounds__(kThreads) fused_kstep_kernel(
    const T* __restrict__ y, T* __restrict__ y_out, T* __restrict__ ss,
    T* work, const T* __restrict__ h_ptr, const T* __restrict__ fz_ptr,
    const int* __restrict__ nc_ptr, int* counts, ProfileRhs<Kin, T> rhs,
    KStepPlan plan, int full, StageTable tab, T rtol, T atol) {
  __shared__ T warp_sums[kThreads / 32];
  __shared__ T region[2 * kRegion];
  crd::cg::grid_group grid = crd::cg::this_grid();
  const WrapGrid wg{plan.ny, plan.nx};
  const size_t plane = wg.plane();
  const size_t first = static_cast<size_t>(blockIdx.x) * blockDim.x
                       + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const int nc = *nc_ptr;
  const int K = plan.k;
  const int n = tab.n;

  if (nc < 0 && !(full == 0 && nc <= -2)) return;
  const int commit = nc < 0 ? 0 : min(nc, K);
  const int steps = nc < 0 ? 0 : (full ? K : commit);
  if (nc >= 0 && counts != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(counts + (full ? 0 : 1), 1);
  if (commit == 0)
    for (size_t g = first; g < 2 * plane; g += stride) y_out[g] = y[g];
  if (steps == 0) return;

  const T h = *h_ptr;
  const T fz = *fz_ptr;
  T* const ks = work + 4 * plane;     // n stage slots of two planes
  const int W = kTileX + 2;           // the region's row stride
  const int R = plan.tile_y + 2;
  T* const su = region;               // the stage input, variable 0
  T* const sv = region + W * R;       // and variable 1

  int z = 0;                          // the slot of the sub-step's k_0
  const T* ycur = y;
  for (int pass = 0, j = 0; j < steps; ++pass) {
    // pass 0 evaluates k_0 = f(y); then sub-step j's stage s on pass
    // 1 + (n - 1) j + s - 1, the last stage also forming y_{j+1}
    const int s = pass == 0 ? 0 : (pass - 1) % (n - 1) + 1;
    const bool last = s == n - 1;
    T* ku[crd::kErkMaxStages];        // k_i's variable 0; variable 1 after
    T* kv[crd::kErkMaxStages];
#pragma unroll
    for (int i = 0; i < crd::kErkMaxStages; ++i) {
      ku[i] = ks + static_cast<size_t>((z + i) % n) * 2 * plane;
      kv[i] = ku[i] + plane;
    }
    T* const kout = ks + static_cast<size_t>((z + s) % n) * 2 * plane;
    T* const ynext = work + static_cast<size_t>(j & 1) * 2 * plane;
    for (int t = blockIdx.x; t < plan.n_tiles; t += gridDim.x) {
      const int gy0 = (t / plan.tiles_x) * plan.tile_y;
      const int gx0 = (t % plan.tiles_x) * kTileX;
      // the stage input on the tile and one ring, as a K1 tile holds it
      for (int p = threadIdx.x; p < W * R; p += blockDim.x) {
        const int ly = p / W, lx = p - ly * W;
        const size_t g = wg.at(gy0 - 1 + ly, gx0 - 1 + lx);
        su[p] = stage_input(tab, s, h, ycur, ku, g);
        sv[p] = stage_input(tab, s, h, ycur + plane, kv, g);
      }
      __syncthreads();
      T acc = T(0);
      for (int q = threadIdx.x; q < kTileX * plan.tile_y; q += blockDim.x) {
        const int ty = q / kTileX, tx = q - ty * kTileX;
        const int gy = gy0 + ty, gx = gx0 + tx;
        if (gy >= plan.ny || gx >= plan.nx) continue;
        const size_t g = wg.at(gy, gx);
        T du, dv;
        rhs(fz, su, sv, (ty + 1) * W + tx + 1, W, gy, gx, du, dv);
        kout[g] = du;
        kout[plane + g] = dv;
        if (!last) continue;
        // y_{j+1} and the error at g; WRMS weights from y_j
        const T u0 = ycur[g], v0 = ycur[plane + g];
        T nu = u0, nv = v0, eu = T(0), ev = T(0);
#pragma unroll
        for (int i = 0; i < crd::kErkMaxStages; ++i) {
          if (i >= n) break;
          const T ki_u = i == s ? du : ku[i][g];
          const T ki_v = i == s ? dv : kv[i][g];
          if (tab.b[i] != 0.0) {
            const T hb = h * static_cast<T>(tab.b[i]);
            nu = nu + hb * ki_u;
            nv = nv + hb * ki_v;
          }
          if (tab.d[i] != 0.0) {
            const T hd = h * static_cast<T>(tab.d[i]);
            eu = eu + hd * ki_u;
            ev = ev + hd * ki_v;
          }
        }
        ynext[g] = nu;
        ynext[plane + g] = nv;
        if (j + 1 == commit) {
          y_out[g] = nu;
          y_out[plane + g] = nv;
        }
        const T wu = eu * (T(1) / (rtol * fabs(u0) + atol));
        const T wv = ev * (T(1) / (rtol * fabs(v0) + atol));
        acc = acc + wu * wu;
        acc = acc + wv * wv;
      }
      if (last)
        store_tile_sum(acc, warp_sums,
                       ss + static_cast<size_t>(t) * K + j);
      else
        __syncthreads();              // the region is free for the next tile
    }
    if (last) {
      // FSAL: the last stage is the next sub-step's k_0
      z = (z + n - 1) % n;
      ycur = ynext;
      ++j;
      if (j == steps) break;
    }
    grid.sync();
  }
}

// The tableau is FSAL: its last stage's input is the update (a[n-1] == b),
// so the stage evaluated at the update is the next step's first.
bool is_fsal(int n, const double* a, const double* b) {
  for (int j = 0; j < n; ++j)
    if (a[(n - 1) * n + j] != b[j]) return false;
  return true;
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
      || !is_fsal(n_stages, a, b) || !crd::valid_kinetics(kinetics)
      || k < 1 || ny < 1 || nx < 1 || tile_y < 1 || tile_y > kMaxTileY)
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::RhsConstants<T> kc = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const int tiles_x = (nx + kTileX - 1) / kTileX;
  KStepPlan plan = {ny, nx, tile_y, tiles_x,
                    tiles_x * ((ny + tile_y - 1) / tile_y), k};
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
  const auto go = [&](auto rhs, auto kernel) {
    void* args[] = {&y_arg, &yout_arg, &ss_arg, &work_arg, &h_arg, &fz_arg,
                    &nc_arg, &counts_arg, &rhs, &plan, &full, &tab,
                    &rtol_arg, &atol_arg};
    return crd::launch_cooperative(kernel, n_points, plan.n_tiles,
                                   &n_blocks, args, stream);
  };
  if (kinetics == crd::kFhn)
    return go(ProfileRhs<crd::kFhn, T>{kc},
              &fused_kstep_kernel<crd::kFhn, T>);
  if (kinetics == crd::kGoldbeter)
    return go(ProfileRhs<crd::kGoldbeter, T>{kc},
              &fused_kstep_kernel<crd::kGoldbeter, T>);
  return go(ProfileRhs<crd::kAlievPanfilov, T>{kc},
            &fused_kstep_kernel<crd::kAlievPanfilov, T>);
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
