// The one-pass tile scheme of the port's fused IMEX ARK3(2)4L[2]SA step
// kernel K3 (fused_imex.cu, the periodic grid). Its grid policy is a
// template parameter (rhs_common.cuh): WrapGrid, whose halo is a modular
// index at load, or HaloGrid, one shard's block inside a halo the exchange
// filled, whose mirror-pad cells counted() leaves out of both parts of the
// partial sum. K10's register-resident scheme (imex_slots.cuh) shares its
// tableau (ImexTable) and constants and keeps its partial sums' order bit
// for bit.
//
// One launch performs a whole additive Runge-Kutta step
// (integrate/imex.py::make_imex_step_err): the 4 explicit stencil
// evaluations kE_i = f_ex(Y_i); the 3 implicit stages, each solving
// Y = rhs_known + (h gamma) f_im(Y) at every point by 3 full Newton
// iterations (closed-form 2x2 Jacobian, residual, Cramer solve); the stage
// slopes kI_i = (Y_i - rhs_known_i)/(h gamma); y_new = y0 + sum (h B_j)
// (kE_j + kI_j); err = sum (h D_j)(kE_j + kI_j); and one partial sum per
// thread block of sum (err w)^2 + (1/NEWTON_TOL)^2 sum_stages (dy w)^2,
// with w = 1/(rtol |y0| + atol) and dy each stage's last Newton update,
// over the points the grid counts (summed by the caller; no float atomics,
// so two launches on the same input give bitwise-equal results).
//
// Design: each block owns a tile_y x tile_x tile and loads it with a halo
// of 4 rings through the grid policy: each explicit evaluation consumes one
// ring and the Newton work, being pointwise, none. Stage i's Newton runs on
// every point at depth >= i (the tile grown by 4 - i rings), because stage
// i + 1's stencil reads Y_i there. Only variable 0 diffuses, so only its
// stage value goes to shared memory for the stencil; kE of variable 1 is 0
// and never stored. Shared memory holds y0 (2), the stage value of variable
// 0 (1), kE_0..2 of variable 0 (3; kE_3 is evaluated on the tile at the
// end) and kI_0..3 (8): 14 arrays of the halo region. rhs_known, the Newton
// iterate and its update stay in the registers of the thread that owns the
// point. rhs_known, y_new and err are accumulated in the plain version's j
// order, the arithmetic follows the plain version (ops/fused_imex.py::
// imex_stages_reference) operation for operation, and the library is built
// with -fmad=false, so each operation rounds as PyTorch's does. A zero
// determinant gives NaN, which reaches the partial sum (a rejected step):
// nothing is masked. The kinetics family is a template parameter. No tensor
// cores, TMA or tuning yet.

#pragma once

#include <cuda_runtime.h>

#include "rhs_common.cuh"

namespace crd {

constexpr int kImexStages = 4;
constexpr int kImexHalo = 4;             // one ring per explicit evaluation
constexpr int kImexArrays = 14;          // shared arrays of the halo region
constexpr int kImexNewtonIters = 3;      // integrate/imex.py NEWTON_ITERS
constexpr double kImexNewtonPenalty = 100.0;   // (1 / NEWTON_TOL)^2
constexpr int kImexThreads = 256;

struct ImexTable {
  double ae[kImexStages][kImexStages];
  double ai[kImexStages][kImexStages];
  double b[kImexStages];
  double d[kImexStages];                 // b - bhat
  double gamma;
};

// AE and AI row-major (4 x 4), B and D of 4 stages, and gamma
inline ImexTable make_imex_table(const double* ae, const double* ai,
                                 const double* b, const double* d,
                                 double gamma) {
  ImexTable tab = {};
  for (int s = 0; s < kImexStages; ++s) {
    for (int j = 0; j < kImexStages; ++j) {
      tab.ae[s][j] = ae[s * kImexStages + j];
      tab.ai[s][j] = ai[s * kImexStages + j];
    }
    tab.b[s] = b[s];
    tab.d[s] = d[s];
  }
  tab.gamma = gamma;
  return tab;
}

// ny x nx is the extent the tiles cover: the grid's, or the shard's block.
template <int Kin, class Grid, typename T>
__global__ void __launch_bounds__(kImexThreads) fused_imex_tile_kernel(
    const T* __restrict__ y, T* __restrict__ y_new, T* __restrict__ ss,
    const T* __restrict__ h_ptr, const T* __restrict__ fz_ptr,
    RhsConstants<T> k, Grid grid, int ny, int nx, int tile_x, int tile_y,
    ImexTable tab, T rtol, T atol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kImexThreads / 32];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int W = tile_x + 2 * kImexHalo;   // region width (x, contiguous)
  const int R = tile_y + 2 * kImexHalo;   // region rows
  const int np = W * R;
  T* y0u = smem;                      // the step's start, both variables
  T* y0v = y0u + np;
  T* yu = y0v + np;                   // the stage value of variable 0
  T* kEu = yu + np;                   // kE_j of variable 0 at kEu + j*np
  T* kI = kEu + 3 * np;               // kI_j: u at kI + 2j*np, v after
  const int gx0 = blockIdx.x * tile_x - kImexHalo;
  const int gy0 = blockIdx.y * tile_y - kImexHalo;
  const size_t plane = grid.plane();

  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const int ly = p / W, lx = p - ly * W;
    const size_t g = grid.at(gy0 + ly, gx0 + lx);
    y0u[p] = y[g];
    y0v[p] = y[plane + g];
  }
  const T h = *h_ptr;
  const T fz = k.has_freeze ? *fz_ptr : T(0);
  const T hg = h * static_cast<T>(tab.gamma);
  __syncthreads();

  // stage 0: kE_0 = f_ex(y0) and kI_0 = f_im(y0) on the points at depth >= 1
  {
    const int w = W - 2, r = R - 2;
    for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
      const int ly = 1 + q / w, lx = 1 + q % w;
      const int p = ly * W + lx;
      const int gy = grid.row(gy0 + ly), gx = grid.col(gx0 + lx);
      T lap = profile_lap(k, y0u, p, W, gx);
      T fu, fv;
      kinetics<Kin>(y0u[p], y0v[p], beta_at(k, gy), fu, fv);
      if (k.has_freeze) {
        const T live = live_at(k, fz, gy);
        lap = lap * live;
        fu = fu * live;
        fv = fv * live;
      }
      kEu[p] = lap;
      kI[p] = fu;
      kI[np + p] = fv;
    }
  }
  __syncthreads();

  // implicit stages s = 1..3 on the points at depth >= s, each followed by
  // its explicit evaluation on the points at depth >= s + 1 (kE_3 waits for
  // the tile loop below)
  T dacc = T(0);      // this thread's sum of (dy w)^2 over the tile
  for (int s = 1; s < kImexStages; ++s) {
    const int w = W - 2 * s, r = R - 2 * s;
    for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
      const int ly = s + q / w, lx = s + q % w;
      const int p = ly * W + lx;
      const int gy = grid.row(gy0 + ly);
      // rhs_known = y0 + sum_j (h AE[s][j]) kE_j + (h AI[s][j]) kI_j
      T ru = y0u[p], rv = y0v[p];
      for (int j = 0; j < s; ++j) {
        if (tab.ae[s][j] != 0.0)
          ru = ru + (h * static_cast<T>(tab.ae[s][j])) * kEu[j * np + p];
        if (tab.ai[s][j] != 0.0) {
          const T hai = h * static_cast<T>(tab.ai[s][j]);
          ru = ru + hai * kI[(2 * j) * np + p];
          rv = rv + hai * kI[(2 * j + 1) * np + p];
        }
      }
      // the stage predictor, then full Newton on Y - hg f_im(Y) = rhs_known
      T Yu = ru + hg * kI[(2 * s - 2) * np + p];
      T Yv = rv + hg * kI[(2 * s - 1) * np + p];
      const T b = beta_at(k, gy);
      const T live = k.has_freeze ? live_at(k, fz, gy) : T(1);
      T du = T(0), dv = T(0);
      for (int it = 0; it < kImexNewtonIters; ++it) {
        T j00, j01, j10, j11, fu, fv;
        jacobian<Kin>(Yu, Yv, b, j00, j01, j10, j11);
        kinetics<Kin>(Yu, Yv, b, fu, fv);
        if (k.has_freeze) {
          j00 = j00 * live;
          j01 = j01 * live;
          j10 = j10 * live;
          j11 = j11 * live;
          fu = fu * live;
          fv = fv * live;
        }
        const T m00 = T(1) - hg * j00, m01 = T(0) - hg * j01;
        const T m10 = T(0) - hg * j10, m11 = T(1) - hg * j11;
        const T r0 = -((Yu - hg * fu) - ru);
        const T r1 = -((Yv - hg * fv) - rv);
        const T det = m00 * m11 - m01 * m10;
        du = (m11 * r0 - m01 * r1) / det;
        dv = (m00 * r1 - m10 * r0) / det;
        Yu = Yu + du;
        Yv = Yv + dv;
      }
      const int ty = ly - kImexHalo, tx = lx - kImexHalo;
      const int ey = blockIdx.y * tile_y + ty, ex = blockIdx.x * tile_x + tx;
      if (ty >= 0 && ty < tile_y && tx >= 0 && tx < tile_x && ey < ny
          && ex < nx && grid.counted(ey, ex)) {
        const T su = du * (T(1) / (rtol * fabs(y0u[p]) + atol));
        const T sv = dv * (T(1) / (rtol * fabs(y0v[p]) + atol));
        dacc = dacc + su * su;
        dacc = dacc + sv * sv;
      }
      yu[p] = Yu;
      kI[(2 * s) * np + p] = (Yu - ru) / hg;
      kI[(2 * s + 1) * np + p] = (Yv - rv) / hg;
    }
    __syncthreads();
    if (s < kImexStages - 1) {
      const int dep = s + 1;
      const int we = W - 2 * dep, re = R - 2 * dep;
      for (int q = threadIdx.x; q < we * re; q += blockDim.x) {
        const int ly = dep + q / we, lx = dep + q % we;
        const int p = ly * W + lx;
        T lap = profile_lap(k, yu, p, W, grid.col(gx0 + lx));
        if (k.has_freeze) lap = lap * live_at(k, fz, grid.row(gy0 + ly));
        kEu[s * np + p] = lap;
      }
      __syncthreads();
    }
  }

  // kE_3, y_new and the error on the tile; WRMS weights from the step's
  // start
  T acc = T(0);
  for (int q = threadIdx.x; q < tile_x * tile_y; q += blockDim.x) {
    const int ty = q / tile_x, tx = q - ty * tile_x;
    const int gy = blockIdx.y * tile_y + ty, gx = blockIdx.x * tile_x + tx;
    if (gy >= ny || gx >= nx) continue;
    const int p = (ty + kImexHalo) * W + tx + kImexHalo;
    T ke3 = profile_lap(k, yu, p, W, grid.col(gx));
    if (k.has_freeze) ke3 = ke3 * live_at(k, fz, grid.row(gy));
    const T u0 = y0u[p], v0 = y0v[p];
    T nu = u0, nv = v0, eu = T(0), ev = T(0);
    for (int j = 0; j < kImexStages; ++j) {
      const T ksu = (j < kImexStages - 1 ? kEu[j * np + p] : ke3)
                    + kI[(2 * j) * np + p];
      const T ksv = kI[(2 * j + 1) * np + p];     // kE of variable 1 is 0
      if (tab.b[j] != 0.0) {
        const T hb = h * static_cast<T>(tab.b[j]);
        nu = nu + hb * ksu;
        nv = nv + hb * ksv;
      }
      if (tab.d[j] != 0.0) {
        const T hd = h * static_cast<T>(tab.d[j]);
        eu = eu + hd * ksu;
        ev = ev + hd * ksv;
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
  acc = acc + static_cast<T>(kImexNewtonPenalty) * dacc;

  store_block_sum<T, kImexThreads>(acc, warp_sums, ss);
}

// Launch one step of fused_imex_tile_kernel over ny x nx points of `grid`
// on `stream` with the kinetics `kinetics`; returns the CUDA error code (0
// on success), checked right after the launch.
template <class Grid, typename T>
int launch_imex_tile(Grid grid, const void* y, void* y_new, void* ss,
                     const void* h, const void* fz, const RhsConstants<T>& k,
                     int kinetics, int ny, int nx, int tile_x, int tile_y,
                     const ImexTable& tab, double rtol, double atol,
                     void* stream) {
  if (ny < 1 || nx < 1 || tile_x < 1 || tile_y < 1
      || !valid_kinetics(kinetics))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kImexArrays)
                      * (tile_x + 2 * kImexHalo) * (tile_y + 2 * kImexHalo)
                      * sizeof(T);
  auto kernel = kinetics == kFhn
                    ? &fused_imex_tile_kernel<kFhn, Grid, T>
                : kinetics == kGoldbeter
                    ? &fused_imex_tile_kernel<kGoldbeter, Grid, T>
                    : &fused_imex_tile_kernel<kAlievPanfilov, Grid, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks((nx + tile_x - 1) / tile_x, (ny + tile_y - 1) / tile_y);
  kernel<<<blocks, kImexThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(y_new), static_cast<T*>(ss),
      static_cast<const T*>(h), static_cast<const T*>(fz), k, grid, ny, nx,
      tile_x, tile_y, tab, static_cast<T>(rtol), static_cast<T>(atol));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace crd
