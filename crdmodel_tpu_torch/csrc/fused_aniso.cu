// Fused embedded-ERK step of the 9-point anisotropic tensor operator
// div(D grad u), D = [[Dxx, Dxy], [Dxy, Dyy]] a field, with FitzHugh-Nagumo,
// Goldbeter or Aliev-Panfilov kinetics (kernel K5 of the port).
//
// Replaces crdmodel_tpu/ops/pallas_aniso.py::build_fused_aniso_step, the
// Pallas TPU kernel that takes every attempted step of an ERK run with a
// diffusion tensor on the flat surface (cardiac fibre anisotropy). One
// launch performs a whole step: stage inputs y0 + sum (h a[s][j]) k_j;
// k_s = kinetics + axis + (t1 + t2) on variable 0 (rhs_common.cuh::
// aniso_rhs, the JAX kernel's association on the folded dxyw), times
// live = 1 - fz(1 - mask) with a freeze; y_new = y0 + sum (h b_s) k_s and
// err = sum (h d_s) k_s in the plain version's order; one partial sum of
// (err / (rtol |y0| + atol))^2 per block, in a fixed order.
//
// What bounds it on an H100: each step reads the state (2 x ny x nx) and
// the three coefficient fields aE, aN, dxyw (ny x nx each) once and writes
// y_new once: about 17.9 MB a step on 1600x400 in f32, some 5.3 us at the
// published 3.35 TB/s. The arithmetic is about 40 operations a point a
// stage. As in K1 and K4, the step is bound by latency and issue long
// before either.
//
// Design: bs32, the main path's tableau, takes erk_slots.cuh's scheme on
// K1's 32x32 tiles: 512 threads fixed to the tile and its n - 1 rings, a
// point's stage inputs and error accumulating in its thread's registers,
// its coefficients read from device memory once a launch into registers
// (AnisoRhs::point: aE and aN at the point, aE at the west neighbour for
// aW, aN at the row below for aS, beta and live), dxyw, which the mixed
// fluxes read at the four neighbours, in one shared plane of the region
// loaded with the step's start, the stage input's variable 0 in two
// shared planes, one block barrier a stage; a tile whose region lies
// inside the grid takes code without the wrap, the others wrap by loops.
// zonneveld43 and dopri54 take erk_tile.cuh's scheme, which reads the
// coefficients through the read-only data cache at every evaluation, by
// the launcher's dispatch on the stage count (launch_erk_slots_on). The
// 9-point stencil reads the diagonal neighbours, which lie in the same
// one-cell ring as the axis neighbours, so each stage consumes one ring in
// both schemes. Under no-flux walls the wrapped values meet zero aE/aN
// faces and zero Dxy wall layers, so they contribute exact zeros. The
// arithmetic follows the plain version (ops/fused_aniso.py::
// fused_aniso_step_reference) operation for operation, and the library is
// built with -fmad=false; each partial sum adds its tile's points in
// erk_tile.cuh's order, so y_new and every partial sum are bitwise those
// of the plain version and of erk_tile.cuh's. No tensor cores or TMA.

#include <cuda_runtime.h>

#include "erk_slots.cuh"
#include "rhs_common.cuh"

namespace {

// the operator on the periodic grid
template <int Kin, typename T>
using Rhs = crd::AnisoRhs<Kin, T, crd::WrapGrid>;

template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* ae, const void* an, const void* dxyw,
           const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int ny, int nx, int tile_x,
           int tile_y, int n_stages, const double* a, const double* b,
           const double* d, double rtol, double atol, void* stream) {
  crd::StageTable tab;
  if (!crd::make_stage_table(n_stages, a, b, d, &tab)
      || !crd::valid_kinetics(kinetics))
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::TensorConstants<T> c = {static_cast<const T*>(ae),
                                     static_cast<const T*>(an),
                                     static_cast<const T*>(dxyw)};
  const crd::RhsConstants<T> k = {
      nullptr, nullptr, nullptr, 0, static_cast<const T*>(beta), beta_field,
      static_cast<const T*>(mask), has_freeze};
  const crd::WrapGrid grid = {ny, nx};
  if (kinetics == crd::kFhn)
    return crd::launch_erk_slots_on<Rhs<crd::kFhn, T>, T>(
        {c, k, grid}, grid, y, y_new, ss, h, fz, ny, nx, tile_x, tile_y, tab,
        rtol, atol, stream);
  if (kinetics == crd::kGoldbeter)
    return crd::launch_erk_slots_on<Rhs<crd::kGoldbeter, T>, T>(
        {c, k, grid}, grid, y, y_new, ss, h, fz, ny, nx, tile_x, tile_y, tab,
        rtol, atol, stream);
  return crd::launch_erk_slots_on<Rhs<crd::kAlievPanfilov, T>, T>(
      {c, k, grid}, grid, y, y_new, ss, h, fz, ny, nx, tile_x, tile_y, tab,
      rtol, atol, stream);
}

// crd::slots_kernel_info of the bs32 kernel of `kinetics` in T
template <typename T>
int info(int kinetics, int* out) {
  if (kinetics == crd::kFhn)
    return crd::slots_kernel_info<Rhs<crd::kFhn, T>, crd::WrapGrid, T>(out);
  if (kinetics == crd::kGoldbeter)
    return crd::slots_kernel_info<Rhs<crd::kGoldbeter, T>, crd::WrapGrid,
                                  T>(out);
  if (kinetics == crd::kAlievPanfilov)
    return crd::slots_kernel_info<Rhs<crd::kAlievPanfilov, T>, crd::WrapGrid,
                                  T>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define CRD_FUSED_ANISO_ARGS                                                 \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,      \
      const void *ae, const void *an, const void *dxyw, const void *beta,   \
      int beta_field, const void *mask, int has_freeze, int kinetics,       \
      int ny, int nx, int tile_x, int tile_y, int n_stages,                 \
      const double *a, const double *b, const double *d, double rtol,       \
      double atol, void *stream
#define CRD_FUSED_ANISO_PASS                                                 \
  y, y_new, ss, h, fz, ae, an, dxyw, beta, beta_field, mask, has_freeze,    \
      kinetics, ny, nx, tile_x, tile_y, n_stages, a, b, d, rtol, atol,      \
      stream

extern "C" int crd_fused_aniso_step_f32(CRD_FUSED_ANISO_ARGS) {
  return launch<float>(CRD_FUSED_ANISO_PASS);
}

extern "C" int crd_fused_aniso_step_f64(CRD_FUSED_ANISO_ARGS) {
  return launch<double>(CRD_FUSED_ANISO_PASS);
}

extern "C" int crd_fused_aniso_info(int f64, int kinetics, int* out) {
  return f64 ? info<double>(kinetics, out) : info<float>(kinetics, out);
}
