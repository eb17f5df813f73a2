// Fused embedded-ERK step of the divergence-form (face-coefficient)
// operator with FitzHugh-Nagumo, Goldbeter or Aliev-Panfilov kinetics
// (kernel K4 of the port).
//
// Replaces crdmodel_tpu/ops/pallas_divform.py::build_fused_divform_step, the
// Pallas TPU kernel that takes every attempted step of an ERK run whose
// operator exists only in the divergence form: no-flux domain walls,
// obstacle scars, 2-D diffusion fields, and diffusion fields on the flat
// surface (the bounded cardiac-tissue program). One launch performs a whole
// step, with the tile scheme of K1 (erk_slots.cuh): stage inputs
// y0 + sum (h a[s][j]) k_j; k_s = kinetics + aE(uE-u) + aW(uW-u) + aN(uN-u)
// + aS(uS-u) on variable 0, times live = 1 - fz(1 - mask) with a freeze,
// times the 0/1 tissue field with an obstacle; y_new = y0 + sum (h b_s) k_s
// and err = sum (h d_s) k_s in the plain version's order; one partial sum of
// (err / (rtol |y0| + atol))^2 per block, in a fixed order.
//
// What bounds it on an H100: each step reads the state (2 x ny x nx) and
// the three face fields and the tissue field (ny x nx each) once and writes
// y_new once: about 20.5 MB a bs32 step on 1600x400 in f32, some 6 us at
// the published 3.35 TB/s. The arithmetic is a few dozen flops a point a
// stage. The step is bound by latency and issue long before either.
//
// Design: bs32, the main path's tableau, takes erk_slots.cuh's scheme on
// K1's tiles: 512 threads fixed to the tile and its n - 1 rings, a point's
// stage inputs and error accumulating in its thread's registers, its
// coefficients read from device memory once a launch into registers
// (DivformRhs::point), the stage input's variable 0 in two shared planes,
// one block barrier a stage; a tile whose region lies inside the grid
// takes code without the wrap, the others wrap by loops (under no-flux
// walls and obstacles the wrapped values meet zero face coefficients).
// zonneveld43 and dopri54 take erk_tile.cuh's scheme, by the
// launcher's dispatch on the stage count (launch_erk_slots_on). aS is not
// shipped: it is aN of the row below, wrapped, exact because the wrapper
// checks aS == roll_y(aN) on the float64 fields before it builds the
// constants. aW ships: on the torus it is not a roll of aE. The arithmetic
// follows the plain version (ops/fused_divform.py::
// fused_divform_step_reference) operation for operation, and the library
// is built with -fmad=false; each partial sum adds its tile's points in
// erk_tile.cuh's order, so y_new and every partial sum are bitwise those
// of the plain version and of erk_tile.cuh's. No tensor cores or TMA.
//
// A structured forcing enters as in K1 (fused_step.cu;
// pallas_divform.py:171-198, 249-256, 344): stage s adds
// (amps[j][s] * rows[j][r]) * cols[j][c] to its variable's right-hand
// side, before the live factor and the tissue field (make_rhs's
// mask_tissue). The ring points of a tile read the profiles at the
// wrapped indices their state comes from; under no-flux walls those
// points are the periodic grid's, whose values meet zero face
// coefficients, so the forcing there reaches no point of the tile. n_stim
// = 0 takes the unforced instantiation.

#include <cuda_runtime.h>

#include "erk_slots.cuh"
#include "rhs_common.cuh"

namespace {

// the operator on the periodic grid
template <int Kin, typename T>
using Rhs = crd::DivformRhs<Kin, T, crd::WrapGrid>;

// amps, rows, cols, n_stim, n_cols, var1: the structured forcing
// (n_stim = 0 and null pointers without one)
template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* ae, const void* aw, const void* an,
           const void* tissue, const void* beta, int beta_field,
           const void* mask, int has_freeze, int kinetics, int ny, int nx,
           int tile_x, int tile_y, int n_stages, const double* a,
           const double* b, const double* d, double rtol, double atol,
           void* stream) {
  crd::StageTable tab;
  if (!crd::make_stage_table(n_stages, a, b, d, &tab)
      || !crd::valid_kinetics(kinetics))
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::FaceConstants<T> f = {
      static_cast<const T*>(ae), static_cast<const T*>(aw),
      static_cast<const T*>(an), static_cast<const T*>(tissue)};
  const crd::RhsConstants<T> k = {
      nullptr, nullptr, nullptr, 0, static_cast<const T*>(beta), beta_field,
      static_cast<const T*>(mask), has_freeze};
  const crd::WrapGrid grid = {ny, nx};
  return crd::with_stim<T>(
      amps, rows, cols, n_stim, n_cols, var1, n_cols == n_stages, ny, nx,
      [&](auto stim) {
        return crd::with_kinetics(kinetics, [&](auto kin) {
          return crd::launch_erk_slots_on<Rhs<decltype(kin)::value, T>, T>(
              {f, k, grid}, grid, y, y_new, ss, h, fz, ny, nx, tile_x,
              tile_y, tab, rtol, atol, stream, stim);
        });
      });
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

#define CRD_FUSED_DIVFORM_ARGS                                              \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,      \
      const void *amps, const void *rows, const void *cols, int n_stim,     \
      int n_cols, int var1, const void *ae, const void *aw,                 \
      const void *an, const void *tissue, const void *beta,                 \
      int beta_field, const void *mask, int has_freeze, int kinetics,       \
      int ny, int nx, int tile_x, int tile_y, int n_stages,                 \
      const double *a, const double *b, const double *d, double rtol,       \
      double atol, void *stream
#define CRD_FUSED_DIVFORM_PASS                                              \
  y, y_new, ss, h, fz, amps, rows, cols, n_stim, n_cols, var1, ae, aw,      \
      an, tissue, beta, beta_field, mask, has_freeze, kinetics, ny, nx,     \
      tile_x, tile_y, n_stages, a, b, d, rtol, atol, stream

extern "C" int crd_fused_divform_step_f32(CRD_FUSED_DIVFORM_ARGS) {
  return launch<float>(CRD_FUSED_DIVFORM_PASS);
}

extern "C" int crd_fused_divform_step_f64(CRD_FUSED_DIVFORM_ARGS) {
  return launch<double>(CRD_FUSED_DIVFORM_PASS);
}

extern "C" int crd_fused_divform_info(int f64, int kinetics, int* out) {
  return f64 ? info<double>(kinetics, out) : info<float>(kinetics, out);
}
