// Device functions shared by the port's fused step kernels (K1
// fused_step.cu, K2 fused_rkc.cu): the periodic wrap, and the right-hand
// side at one point of a tile held in shared memory, the 5-point profile
// operator on variable 0 plus FitzHugh-Nagumo kinetics, times the row
// freeze. Counterpart of crdmodel_tpu/ops/kernel_common.py::make_rhs_block;
// the plain torch version is ops/kernel_common.py::make_rhs_block, and the
// expressions below keep its association order, so that a kernel built with
// -fmad=false rounds as PyTorch does.

#pragma once

#include <cuda_runtime.h>

namespace crd {

constexpr double kFhnEpsilon = 0.36;   // models/fhn.py EPSILON

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// The RHS's constant inputs, all on the device: the stencil (three (nx,)
// profiles on the torus, three scalars on the flat surface), beta (a
// scalar or an (ny,) field) and the (ny,) interior-row mask.
template <typename T>
struct RhsConstants {
  const T* c0;
  const T* c1;
  const T* c2;
  int torus;
  const T* beta;
  int beta_field;
  const T* mask;
  int has_freeze;
};

// ydot = f(u, v) at local point p of a region with row stride W, whose
// global indices are (gy, gx); fz is the freeze scalar of the segment.
template <typename T>
__device__ __forceinline__ void fhn_profile_rhs(
    const RhsConstants<T>& k, T fz, const T* su, const T* sv, int p, int W,
    int gy, int gx, T& du_out, T& dv_out) {
  const T u = su[p], v = sv[p];
  const T uw = su[p - 1], ue = su[p + 1];
  const T us = su[p - W], un = su[p + W];
  T lap;
  if (k.torus) {
    lap = k.c0[gx] * (ue - uw) + k.c1[gx] * (ue - T(2) * u + uw)
          + k.c2[gx] * (un - T(2) * u + us);
  } else {
    lap = k.c0[0] * (uw + ue) + k.c1[0] * (us + un) + k.c2[0] * u;
  }
  const T b = k.beta_field ? k.beta[gy] : k.beta[0];
  T du = (T(3) * u - u * u * u - v) + lap;
  T dv = static_cast<T>(kFhnEpsilon) * (u + b);
  if (k.has_freeze) {
    const T live = T(1) - fz * (T(1) - k.mask[gy]);
    du = du * live;
    dv = dv * live;
  }
  du_out = du;
  dv_out = dv;
}

// One partial sum per block in a fixed order (warp shuffles, then warp 0's
// sums in order): no float atomics, so two launches agree bitwise.
template <typename T, int kThreads>
__device__ __forceinline__ void store_block_sum(T acc, T* warp_sums,
                                                T* out) {
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = T(0);
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    out[blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

}  // namespace crd
