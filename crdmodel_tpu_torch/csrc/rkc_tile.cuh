// The one-pass tile scheme of the fused RKC2 step on one shard of a mesh,
// kernel K9 (fused_shard_rkc.cu); K2 (fused_rkc.cu) runs the same step in
// chunks of stages instead, and shares quiet_nan and kRkcMaxStages from
// here. One launch performs a whole step of s Chebyshev stages
// (integrate/rkc.py):
// F0 = f(y0), Y1 = y0 + (h mu1) F0, for j = 2..s
//   Yj = (1 - mu - nu) y0 + mu Yj-1 + nu Yj-2 + (h mut) f(Yj-1) + (h gt) F0,
// y_new = Ys, F1 = f(y_new), the order-2 error estimate
// est = 0.8 (y0 - y_new) + (0.4 h)(F0 + F1), and one partial sum of squared
// WRMS-scaled errors per thread block (summed by the caller; no float
// atomics, so two launches on the same input give bitwise-equal results).
//
// The stage count s, h, the freeze scalar and the coefficient tables live
// on the device: the kernel reads s and indexes mu1[s] and ctab[s][j]
// itself, so the host never learns s. An s outside [2, s_cap] is refused
// by NaN partial sums, which the adaptive loop rejects.
//
// Design: each block owns a tile_y x tile_x tile and loads it with a halo
// of s + 1 rings through the grid policy (rhs_common.cuh: WrapGrid's
// modular index, any number of times on grids smaller than the halo, or
// HaloGrid's shard block inside the exchange's halo). The three-term
// recurrence has a live set of constant size, kept in shared memory: y0,
// F0, Yj-1 and Yj-2, two variables each. Yj overwrites Yj-2 in place (it
// reads Yj-2 only at its own point), so four buffers carry any s. Stage j
// is evaluated on the points at depth >= j, and F1 on the tile. Shared
// memory is sized for s_cap + 1 rings when the launch is configured,
// before s is known; a smaller s packs its smaller region into the same
// space. The arithmetic follows the plain versions (ops/fused_rkc.py::
// rkc_step_reference) operation for operation, and the library is built
// with -fmad=false. The right-hand side at a point is a functor the kernel
// template takes, as in erk_tile.cuh.

#pragma once

#include <cuda_runtime.h>

#include "rhs_common.cuh"

namespace crd {

constexpr int kRkcMaxStages = 23;    // ops/fused_rkc.py S_MAX_KERNEL
constexpr int kRkcThreads = 512;

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// The functor: rhs(fz, su, sv, p, W, gy, gx, du, dv) writes ydot at local
// point p of a region with row stride W, and the grid policy says where
// the region's points lie (erk_tile.cuh, rhs_common.cuh); ny x nx is the
// extent the tiles cover.
template <class Rhs, class Grid, typename T>
__global__ void __launch_bounds__(kRkcThreads) fused_rkc_step_kernel(
    const T* __restrict__ y, T* __restrict__ y_new, T* __restrict__ ss,
    const T* __restrict__ h_ptr, const T* __restrict__ fz_ptr,
    const int* __restrict__ s_ptr, const T* __restrict__ mu1_tab,
    const T* __restrict__ ctab, int s_cap, Rhs rhs, Grid grid, int ny,
    int nx, int tile_x, int tile_y, T rtol, T atol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_sums[kRkcThreads / 32];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int s = *s_ptr;
  const T h = *h_ptr;
  const T fz = *fz_ptr;
  const size_t plane = grid.plane();
  if (s < 2 || s > s_cap) {
    // no table row for this stage count: keep y, poison the error sum
    for (int q = threadIdx.x; q < tile_x * tile_y; q += blockDim.x) {
      const int ty = q / tile_x, tx = q - ty * tile_x;
      const int gy = blockIdx.y * tile_y + ty, gx = blockIdx.x * tile_x + tx;
      if (gy >= ny || gx >= nx) continue;
      const size_t g = grid.at(gy, gx);
      y_new[g] = y[g];
      y_new[plane + g] = y[plane + g];
    }
    if (threadIdx.x == 0)
      ss[blockIdx.y * gridDim.x + blockIdx.x] = quiet_nan<T>();
    return;
  }

  const int halo = s + 1;
  const int W = tile_x + 2 * halo;    // region width (x, contiguous)
  const int R = tile_y + 2 * halo;    // region rows
  const int np = W * R;
  T* y0u = smem;                      // the step's start
  T* y0v = y0u + np;
  T* f0u = y0v + np;                  // F0 = f(y0)
  T* f0v = f0u + np;
  T* au = f0v + np;                   // Y1, then Yj in turns with b
  T* av = au + np;
  T* bu = av + np;
  T* bv = bu + np;
  const int gx0 = blockIdx.x * tile_x - halo;
  const int gy0 = blockIdx.y * tile_y - halo;

  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    const int ly = p / W, lx = p - ly * W;
    const size_t g = grid.at(gy0 + ly, gx0 + lx);
    y0u[p] = y[g];
    y0v[p] = y[plane + g];
  }
  __syncthreads();

  // F0 and Y1 = y0 + (h mu1) F0 on the points at depth >= 1
  {
    const T hmu1 = h * mu1_tab[s];
    const int w = W - 2, r = R - 2;
    for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
      const int ly = 1 + q / w, lx = 1 + q % w;
      const int p = ly * W + lx;
      T du, dv;
      rhs(fz, y0u, y0v, p, W, grid.row(gy0 + ly), grid.col(gx0 + lx), du,
          dv);
      f0u[p] = du;
      f0v[p] = dv;
      au[p] = y0u[p] + hmu1 * du;
      av[p] = y0v[p] + hmu1 * dv;
    }
  }
  __syncthreads();

  // stages j = 2..s on the points at depth >= j
  const T* pu = y0u;                  // Yj-2
  const T* pv = y0v;
  T* cu = au;                         // Yj-1
  T* cv = av;
  T* du_dst = bu;                     // Yj: b at j = 2, then Yj-2's buffer
  T* dv_dst = bv;
  const T* row = ctab + static_cast<size_t>(s) * (kRkcMaxStages + 1) * 4;
  for (int j = 2; j <= s; ++j) {
    const T mu = row[4 * j], nu = row[4 * j + 1];
    const T mut = row[4 * j + 2], gt = row[4 * j + 3];
    const T cy0 = T(1) - mu - nu;
    const T hmut = h * mut, hgt = h * gt;
    const int w = W - 2 * j, r = R - 2 * j;
    for (int q = threadIdx.x; q < w * r; q += blockDim.x) {
      const int ly = j + q / w, lx = j + q % w;
      const int p = ly * W + lx;
      T fu, fv;
      rhs(fz, cu, cv, p, W, grid.row(gy0 + ly), grid.col(gx0 + lx), fu,
          fv);
      const T yju = cy0 * y0u[p] + mu * cu[p] + nu * pu[p] + hmut * fu
                    + hgt * f0u[p];
      const T yjv = cy0 * y0v[p] + mu * cv[p] + nu * pv[p] + hmut * fv
                    + hgt * f0v[p];
      du_dst[p] = yju;
      dv_dst[p] = yjv;
    }
    __syncthreads();
    pu = cu;
    pv = cv;
    T* old_u = cu;
    T* old_v = cv;
    cu = du_dst;
    cv = dv_dst;
    du_dst = old_u;
    dv_dst = old_v;
  }

  // F1 = f(y_new), y_new and the error on the tile (depth s + 1); WRMS
  // weights from the step's start
  const T h04 = T(0.4) * h;
  T acc = T(0);
  for (int q = threadIdx.x; q < tile_x * tile_y; q += blockDim.x) {
    const int ty = q / tile_x, tx = q - ty * tile_x;
    const int gy = blockIdx.y * tile_y + ty, gx = blockIdx.x * tile_x + tx;
    if (gy >= ny || gx >= nx) continue;
    const int p = (ty + halo) * W + tx + halo;
    T f1u, f1v;
    rhs(fz, cu, cv, p, W, grid.row(gy), grid.col(gx), f1u, f1v);
    const T yu = cu[p], yv = cv[p];
    const size_t g = grid.at(gy, gx);
    y_new[g] = yu;
    y_new[plane + g] = yv;
    if (!grid.counted(gy, gx)) continue;   // a pad cell of a padded mesh
    const T eu = T(0.8) * (y0u[p] - yu) + h04 * (f0u[p] + f1u);
    const T ev = T(0.8) * (y0v[p] - yv) + h04 * (f0v[p] + f1v);
    const T wu = eu * (T(1) / (rtol * fabs(y0u[p]) + atol));
    const T wv = ev * (T(1) / (rtol * fabs(y0v[p]) + atol));
    acc = acc + wu * wu;
    acc = acc + wv * wv;
  }
  store_block_sum<T, kRkcThreads>(acc, warp_sums, ss);
}

// Launch one step of fused_rkc_step_kernel<Rhs, Grid, T> over ny x nx
// points on `stream`; returns the CUDA error code (0 on success), checked
// right after the launch. Shared memory is sized for s_cap + 1 rings.
template <class Rhs, class Grid, typename T>
int launch_rkc_tile(Rhs rhs, Grid grid, const void* y, void* y_new,
                    void* ss, const void* h, const void* fz, const void* s,
                    const void* mu1_tab, const void* ctab, int s_cap, int ny,
                    int nx, int tile_x, int tile_y, double rtol, double atol,
                    void* stream) {
  const int halo = s_cap + 1;
  const size_t smem = static_cast<size_t>(8) * (tile_x + 2 * halo)
                      * (tile_y + 2 * halo) * sizeof(T);
  auto kernel = &fused_rkc_step_kernel<Rhs, Grid, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks((nx + tile_x - 1) / tile_x, (ny + tile_y - 1) / tile_y);
  kernel<<<blocks, kRkcThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<T*>(y_new), static_cast<T*>(ss),
      static_cast<const T*>(h), static_cast<const T*>(fz),
      static_cast<const int*>(s), static_cast<const T*>(mu1_tab),
      static_cast<const T*>(ctab), s_cap, rhs, grid, ny, nx, tile_x, tile_y,
      static_cast<T>(rtol), static_cast<T>(atol));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace crd

