// The tile scheme of the port's fused embedded-ERK step kernels K1
// (fused_step.cu, the 5-point profile operator), K4 (fused_divform.cu, the
// divergence-form operator), K5 (fused_aniso.cu, the 2-D tensor), K8
// (fused_shard_step.cu, K1 on one shard of a mesh) and K11
// (fused_shard_divform.cu, K4 and the 2-D tensor on one shard) for the
// tableaus other than bs32, which those five take on erk_slots.cuh's
// register-resident scheme. They differ in the right-hand side at a point,
// a functor the kernel template takes, and in the grid the tile reads, a
// policy it takes (rhs_common.cuh): WrapGrid, the periodic grid, whose
// halo is a modular index at load (K1, K4, K5), or HaloGrid, one shard's
// block inside a halo the exchange filled (K8, K11).
//
// One launch performs a whole step: every stage's stencil and kinetics, the
// solution update, and one partial sum of squared WRMS-scaled errors per
// thread block. The caller sums the partials (no float atomics, so two
// launches on the same input give bitwise-equal results).
//
// Each thread block owns a tile of tile_y x tile_x points and loads it with
// a halo of n_stages rings, read through the grid policy.
// Stage s is evaluated from shared memory on a region that shrinks by one
// ring per stage, so the last stage is valid on the tile and no stage value
// ever goes to device memory. All stages are evaluated (no FSAL). The
// arithmetic follows the plain versions (ops/fused_step.py::
// fused_step_reference, ops/fused_divform.py::fused_divform_step_reference)
// operation for operation, and the library is built with -fmad=false so
// that no multiply and add are contracted: each operation rounds as
// PyTorch's does.
//
// The functor: rhs(fz, su, sv, p, W, gy, gx, du, dv) writes ydot at local
// point p of a region with row stride W holding u in su and v in sv, whose
// indices into the RHS's constants are (gy, gx) = (grid.row, grid.col) of
// the point; fz is the freeze scalar of the segment. With a structured
// forcing (Stim = StimTable, rhs_common.cuh; K1 and K4), stage s adds
// stimulus j's (amps[j][s] * rows[j][gy]) * cols[j][gx] through the
// functor's forced call rhs(fz, su, sv, p, W, gy, gx, fu, fv, du, dv);
// Stim = NoStim compiles it out.

#pragma once

#include <cuda_runtime.h>

#include "rhs_common.cuh"

namespace crd {

constexpr int kErkMaxStages = 8;
constexpr int kErkThreads = 256;

struct StageTable {
  int n;
  double a[kErkMaxStages][kErkMaxStages];
  double b[kErkMaxStages];
  double d[kErkMaxStages];   // b - bhat
};

// a row-major (n x n), b and d of n stages; false when n is out of range
inline bool make_stage_table(int n, const double* a, const double* b,
                             const double* d, StageTable* tab) {
  if (n < 1 || n > kErkMaxStages) return false;
  *tab = StageTable{};
  tab->n = n;
  for (int s = 0; s < n; ++s) {
    for (int j = 0; j < n; ++j) tab->a[s][j] = a[s * n + j];
    tab->b[s] = b[s];
    tab->d[s] = d[s];
  }
  return true;
}

// The tableau is FSAL: its last stage's input is the update (a[n-1] == b).
inline bool stage_table_is_fsal(const StageTable& tab) {
  for (int j = 0; j < tab.n; ++j)
    if (tab.a[tab.n - 1][j] != tab.b[j]) return false;
  return true;
}

// shared bytes of a tile: y0, yi and n k's, two variables each, with an
// n-ring halo (ops/fused_step.py::tile_plan)
inline size_t erk_tile_smem(int n_stages, int tile_x, int tile_y,
                            size_t itemsize) {
  return static_cast<size_t>(2 * n_stages + 4) * (tile_x + 2 * n_stages)
         * (tile_y + 2 * n_stages) * itemsize;
}

// ny x nx is the extent the tiles cover: the grid's, or the shard's block.
template <class Rhs, class Grid, typename T, class Stim>
__global__ void __launch_bounds__(kErkThreads) fused_erk_tile_kernel(
    const T* __restrict__ y, T* __restrict__ y_new, T* __restrict__ ss,
    const T* __restrict__ h_ptr, const T* __restrict__ fz_ptr, Rhs rhs,
    Grid grid, int ny, int nx, int tile_x, int tile_y, StageTable tab,
    T rtol, T atol, Stim stim) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kErkThreads / 32];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int halo = tab.n;
  const int W = tile_x + 2 * halo;    // region width (x, contiguous)
  const int R = tile_y + 2 * halo;    // region rows
  const int np = W * R;
  T* y0u = smem;                      // the step's start, both variables
  T* y0v = y0u + np;
  T* yiu = y0v + np;                  // the current stage input
  T* yiv = yiu + np;
  T* ks = yiv + np;                   // stage s: u at ks + 2s*np, v after
  const int gx0 = blockIdx.x * tile_x - halo;
  const int gy0 = blockIdx.y * tile_y - halo;
  const size_t plane = grid.plane();

  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const int ly = p / W, lx = p - ly * W;
    const size_t g = grid.at(gy0 + ly, gx0 + lx);
    y0u[p] = y[g];
    y0v[p] = y[plane + g];
  }
  const T h = *h_ptr;
  const T fz = *fz_ptr;
  __syncthreads();

  for (int s = 0; s < tab.n; ++s) {
    const T* su = y0u;
    const T* sv = y0v;
    if (s > 0) {
      // yi = y0 + (h a[s][0]) k_0 + ... on the points at depth >= s
      const int w = W - 2 * s, r = R - 2 * s;
      for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
        const int p = (s + q / w) * W + s + q % w;
        T u = y0u[p], v = y0v[p];
        for (int j = 0; j < s; ++j) {
          if (tab.a[s][j] != 0.0) {
            const T ha = h * static_cast<T>(tab.a[s][j]);
            u = u + ha * ks[(2 * j) * np + p];
            v = v + ha * ks[(2 * j + 1) * np + p];
          }
        }
        yiu[p] = u;
        yiv[p] = v;
      }
      __syncthreads();
      su = yiu;
      sv = yiv;
    }
    // k_s = rhs(yi) on the points at depth >= s + 1
    T* ku = ks + (2 * s) * np;
    T* kv = ku + np;
    const int dep = s + 1;
    const int w = W - 2 * dep, r = R - 2 * dep;
    for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
      const int ly = dep + q / w, lx = dep + q % w;
      const int p = ly * W + lx;
      const int gy = grid.row(gy0 + ly), gx = grid.col(gx0 + lx);
      if constexpr (Stim::kOn) {
        T fu, fv;
        stim.at(s, gy, gx, fu, fv);
        rhs(fz, su, sv, p, W, gy, gx, fu, fv, ku[p], kv[p]);
      } else {
        rhs(fz, su, sv, p, W, gy, gx, ku[p], kv[p]);
      }
    }
    __syncthreads();
  }

  // y_new and the error on the tile; WRMS weights from the step's start
  T acc = T(0);
  for (int q = threadIdx.x; q < tile_x * tile_y; q += blockDim.x) {
    const int ty = q / tile_x, tx = q - ty * tile_x;
    const int gy = blockIdx.y * tile_y + ty, gx = blockIdx.x * tile_x + tx;
    if (gy >= ny || gx >= nx) continue;
    const int p = (ty + halo) * W + tx + halo;
    const T u0 = y0u[p], v0 = y0v[p];
    T nu = u0, nv = v0, eu = T(0), ev = T(0);
    for (int s = 0; s < tab.n; ++s) {
      const T* ku = ks + (2 * s) * np;
      if (tab.b[s] != 0.0) {
        const T hb = h * static_cast<T>(tab.b[s]);
        nu = nu + hb * ku[p];
        nv = nv + hb * ku[np + p];
      }
      if (tab.d[s] != 0.0) {
        const T hd = h * static_cast<T>(tab.d[s]);
        eu = eu + hd * ku[p];
        ev = ev + hd * ku[np + p];
      }
    }
    const size_t g = grid.at(gy, gx);
    y_new[g] = nu;
    y_new[plane + g] = nv;
    if (!grid.counted(gy, gx)) continue;   // a pad cell of a padded mesh
    const T wu = eu * (T(1) / (rtol * fabs(u0) + atol));
    const T wv = ev * (T(1) / (rtol * fabs(v0) + atol));
    acc = acc + wu * wu;
    acc = acc + wv * wv;
  }

  store_block_sum<T, kErkThreads>(acc, warp_sums, ss);
}

// Launch one step of fused_erk_tile_kernel<Rhs, Grid, T, Stim> over
// ny x nx points on `stream`; returns the CUDA error code (0 on success),
// checked right after the launch.
template <class Rhs, typename T, class Grid, class Stim = NoStim>
int launch_erk_tile_on(Rhs rhs, Grid grid, const void* y, void* y_new,
                       void* ss, const void* h, const void* fz, int ny,
                       int nx, int tile_x, int tile_y, const StageTable& tab,
                       double rtol, double atol, void* stream,
                       Stim stim = Stim{}) {
  if (ny < 1 || nx < 1 || tile_x < 1 || tile_y < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = erk_tile_smem(tab.n, tile_x, tile_y, sizeof(T));
  auto kernel = &fused_erk_tile_kernel<Rhs, Grid, T, Stim>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks((nx + tile_x - 1) / tile_x, (ny + tile_y - 1) / tile_y);
  kernel<<<blocks, kErkThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(y_new), static_cast<T*>(ss),
      static_cast<const T*>(h), static_cast<const T*>(fz), rhs, grid, ny,
      nx, tile_x, tile_y, tab, static_cast<T>(rtol), static_cast<T>(atol),
      stim);
  return static_cast<int>(cudaGetLastError());
}

// erk_tile_smem for a family of nv variables: y0, yi and n k's of each
// (ops/fused_step.py::tile_plan with nvars)
inline size_t erk_tile_smem_n(int nv, int n_stages, int tile_x, int tile_y,
                              size_t itemsize) {
  return static_cast<size_t>(nv * (n_stages + 2)) * (tile_x + 2 * n_stages)
         * (tile_y + 2 * n_stages) * itemsize;
}

// fused_erk_tile_kernel for the families of any shape (FamilyRhs: the
// NEW_FAMILIES, unforced; K1 on the periodic grid, K8 on a shard's block
// in its halo): the same tiles, stage regions, update and partial sums,
// with every variable's y0, stage input and stages in shared memory; a
// point's coefficients are read at each evaluation, and its squared
// errors are added variable by variable. ny x nx is the extent the tiles
// cover: the grid's, or the shard's block.
template <int Kin, class Grid, typename T>
__global__ void __launch_bounds__(kErkThreads) fused_erk_tile_n_kernel(
    const T* __restrict__ y, T* __restrict__ y_new, T* __restrict__ ss,
    const T* __restrict__ h_ptr, const T* __restrict__ fz_ptr,
    FamilyRhs<Kin, T> rhs, Grid grid, int ny, int nx, int tile_x,
    int tile_y, StageTable tab, T rtol, T atol) {
  using Fam = Family<Kin>;
  constexpr int NV = Fam::kNv;
  constexpr int ND = Fam::kNd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kErkThreads / 32];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int halo = tab.n;
  const int W = tile_x + 2 * halo;    // region width (x, contiguous)
  const int R = tile_y + 2 * halo;    // region rows
  const int np = W * R;
  T* y0 = smem;                       // the step's start: variable v at
                                      // y0 + v np
  T* yi = y0 + NV * np;               // the current stage input
  T* ks = yi + NV * np;               // stage s, variable v: ks + (s NV + v) np
  const int gx0 = blockIdx.x * tile_x - halo;
  const int gy0 = blockIdx.y * tile_y - halo;
  const size_t plane = grid.plane();

  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const int ly = p / W, lx = p - ly * W;
    const size_t g = grid.at(gy0 + ly, gx0 + lx);
#pragma unroll
    for (int v = 0; v < NV; ++v) y0[v * np + p] = y[v * plane + g];
  }
  const T h = *h_ptr;
  const T fz = *fz_ptr;
  __syncthreads();

  for (int s = 0; s < tab.n; ++s) {
    const T* in = y0;
    if (s > 0) {
      // yi = y0 + (h a[s][0]) k_0 + ... on the points at depth >= s
      const int w = W - 2 * s, r = R - 2 * s;
      for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
        const int p = (s + q / w) * W + s + q % w;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          T x = y0[v * np + p];
          for (int j = 0; j < s; ++j) {
            if (tab.a[s][j] != 0.0) {
              const T ha = h * static_cast<T>(tab.a[s][j]);
              x = x + ha * ks[(j * NV + v) * np + p];
            }
          }
          yi[v * np + p] = x;
        }
      }
      __syncthreads();
      in = yi;
    }
    // k_s = rhs(yi) on the points at depth >= s + 1
    const T* planes[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) planes[i] = in + Fam::var(i) * np;
    const int dep = s + 1;
    const int w = W - 2 * dep, r = R - 2 * dep;
    for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
      const int ly = dep + q / w, lx = dep + q % w;
      const int p = ly * W + lx;
      T yv[NV], dy[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) yv[v] = in[v * np + p];
      rhs.at_point(rhs.point(fz, grid.row(gy0 + ly), grid.col(gx0 + lx)),
                   planes, yv, p, W, dy);
#pragma unroll
      for (int v = 0; v < NV; ++v) ks[(s * NV + v) * np + p] = dy[v];
    }
    __syncthreads();
  }

  // y_new and the error on the tile; WRMS weights from the step's start
  T acc = T(0);
  for (int q = threadIdx.x; q < tile_x * tile_y; q += blockDim.x) {
    const int ty = q / tile_x, tx = q - ty * tile_x;
    const int gy = blockIdx.y * tile_y + ty, gx = blockIdx.x * tile_x + tx;
    if (gy >= ny || gx >= nx) continue;
    const int p = (ty + halo) * W + tx + halo;
    const size_t g = grid.at(gy, gx);
    const bool counted = grid.counted(gy, gx);   // not a mirror-pad cell
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const T x0 = y0[v * np + p];
      T nx = x0, ex = T(0);
      for (int s = 0; s < tab.n; ++s) {
        const T kx = ks[(s * NV + v) * np + p];
        if (tab.b[s] != 0.0) nx = nx + (h * static_cast<T>(tab.b[s])) * kx;
        if (tab.d[s] != 0.0) ex = ex + (h * static_cast<T>(tab.d[s])) * kx;
      }
      y_new[v * plane + g] = nx;
      if (!counted) continue;
      const T wx = ex * (T(1) / (rtol * fabs(x0) + atol));
      acc = acc + wx * wx;
    }
  }

  store_block_sum<T, kErkThreads>(acc, warp_sums, ss);
}

// Launch one step of fused_erk_tile_n_kernel<Kin, Grid, T> over ny x nx
// points on `stream`; returns the CUDA error code (0 on success), checked
// right after the launch.
template <int Kin, typename T, class Grid>
int launch_erk_tile_n(FamilyRhs<Kin, T> rhs, Grid grid, const void* y,
                      void* y_new, void* ss, const void* h, const void* fz,
                      int ny, int nx, int tile_x, int tile_y,
                      const StageTable& tab, double rtol, double atol,
                      void* stream) {
  if (ny < 1 || nx < 1 || tile_x < 1 || tile_y < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = erk_tile_smem_n(Family<Kin>::kNv, tab.n, tile_x,
                                      tile_y, sizeof(T));
  auto kernel = &fused_erk_tile_n_kernel<Kin, Grid, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks((nx + tile_x - 1) / tile_x, (ny + tile_y - 1) / tile_y);
  kernel<<<blocks, kErkThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(y_new), static_cast<T*>(ss),
      static_cast<const T*>(h), static_cast<const T*>(fz), rhs, grid, ny, nx,
      tile_x, tile_y, tab, static_cast<T>(rtol), static_cast<T>(atol));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace crd
