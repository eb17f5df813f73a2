// Fused embedded-ERK step of the 5-point profile operator with
// FitzHugh-Nagumo, Goldbeter or Aliev-Panfilov kinetics (kernel K1 of the
// port).
//
// Replaces crdmodel_tpu/ops/pallas_step.py::build_fused_step, the Pallas TPU
// kernel that takes every attempted step of the canonical FHN and Goldbeter
// torus runs with their own method, bs32.
// One launch performs a whole step: every stage's stencil and kinetics, the
// solution update, and one partial sum of squared WRMS-scaled errors per
// thread block.
//
// What bounds it on an H100: the state (2 x ny x nx) is read once and
// y_new written once (about 10 MB a bs32 step on 400x1600 in f32, some
// 3 us at the published 3.35 TB/s), and the stage arithmetic is a few
// dozen flops a point. Neither bandwidth nor flops is near its limit; a
// step is bound by latency and issue: the block's barriers between stages,
// the shared-memory traffic of the stage values, and the host's launches
// around the kernel.
//
// Design: bs32, the main path's tableau, takes erk_slots.cuh's scheme on
// 32x32 tiles: 512 threads fixed to the tile and its n - 1 rings, a
// point's stage inputs and error accumulating in its thread's registers,
// its coefficients (the three column profiles on the torus, the three
// scalars on the flat surface, beta and live of its row) read from device
// memory once a launch into registers (ProfileRhs::point), the stage
// input's variable 0 in two shared planes, one block barrier a stage; a
// tile whose region lies inside the grid takes code without the wrap, the
// others (the grid's edges, and every tile of a grid narrower than the
// region) wrap by loops. zonneveld43 and dopri54 take erk_tile.cuh's
// scheme, which holds every stage of the tile in shared memory, by the
// launcher's dispatch on the stage count (launch_erk_slots_on). The RHS at
// a point is the shared functor crd::ProfileRhs of rhs_common.cuh, with
// the kinetics family a template parameter (one instance per family). The
// arithmetic follows the plain version (ops/fused_step.py::
// fused_step_reference) operation for operation, the library is built with
// -fmad=false, and each partial sum adds its tile's points in
// erk_tile.cuh's order: y_new and every partial sum are bitwise those of
// the plain version and of erk_tile.cuh's scheme. No tensor cores or TMA.
//
// A structured forcing (core/forcing.py::SeparableForcing, rank-1
// stimuli; pallas_step.py:164-192, 212-222, 303-308) comes in as an
// amplitude table amps[n_stim][n_stages], computed on the device at the
// stage times before the launch, and each stimulus's row and column
// profiles; stage s adds (amps[j][s] * rows[j][r]) * cols[j][c] to its
// variable's right-hand side before the freeze's live factor
// (rhs_common.cuh::StimTable). Each point of a tile's rings reads the
// profiles at the wrapped indices its state comes from, as the JAX
// kernel wrap-pads them (pallas_step.py:178-186). It costs 2 n_stim
// cached loads and 3 n_stim operations a point a stage; without a forcing
// (n_stim = 0) the launcher takes the unforced instantiation, which has
// none of it.

#include <cuda_runtime.h>

#include "erk_slots.cuh"
#include "rhs_common.cuh"

namespace {

using crd::ProfileRhs;
using crd::WrapGrid;

// amps, rows, cols, n_stim, n_cols, var1: the structured forcing
// (n_stim = 0 and null pointers without one)
template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* c0, const void* c1, const void* c2,
           int torus, const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int ny, int nx, int tile_x,
           int tile_y, int n_stages, const double* a, const double* b,
           const double* d, double rtol, double atol, void* stream) {
  crd::StageTable tab;
  if (!crd::make_stage_table(n_stages, a, b, d, &tab)
      || !crd::valid_kinetics(kinetics))
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const WrapGrid grid = {ny, nx};
  return crd::with_stim<T>(
      amps, rows, cols, n_stim, n_cols, var1, n_cols == n_stages, ny, nx,
      [&](auto stim) {
        return crd::with_kinetics(kinetics, [&](auto kin) {
          return crd::launch_erk_slots_on<
              ProfileRhs<decltype(kin)::value, T>, T>(
              {k}, grid, y, y_new, ss, h, fz, ny, nx, tile_x, tile_y, tab,
              rtol, atol, stream, stim);
        });
      });
}

// crd::slots_kernel_info of the bs32 kernel of `kinetics` in T
template <typename T>
int info(int kinetics, int* out) {
  if (kinetics == crd::kFhn)
    return crd::slots_kernel_info<ProfileRhs<crd::kFhn, T>, WrapGrid, T>(out);
  if (kinetics == crd::kGoldbeter)
    return crd::slots_kernel_info<ProfileRhs<crd::kGoldbeter, T>, WrapGrid,
                                  T>(out);
  if (kinetics == crd::kAlievPanfilov)
    return crd::slots_kernel_info<ProfileRhs<crd::kAlievPanfilov, T>,
                                  WrapGrid, T>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define CRD_FUSED_STEP_ARGS                                                 \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,      \
      const void *amps, const void *rows, const void *cols, int n_stim,     \
      int n_cols, int var1, const void *c0, const void *c1,                 \
      const void *c2, int torus, const void *beta, int beta_field,          \
      const void *mask, int has_freeze, int kinetics, int ny, int nx,       \
      int tile_x, int tile_y, int n_stages, const double *a,                \
      const double *b, const double *d, double rtol, double atol,           \
      void *stream
#define CRD_FUSED_STEP_PASS                                                 \
  y, y_new, ss, h, fz, amps, rows, cols, n_stim, n_cols, var1, c0, c1,      \
      c2, torus, beta, beta_field, mask, has_freeze, kinetics, ny, nx,      \
      tile_x, tile_y, n_stages, a, b, d, rtol, atol, stream

extern "C" int crd_fused_erk_step_f32(CRD_FUSED_STEP_ARGS) {
  return launch<float>(CRD_FUSED_STEP_PASS);
}

extern "C" int crd_fused_erk_step_f64(CRD_FUSED_STEP_ARGS) {
  return launch<double>(CRD_FUSED_STEP_PASS);
}

extern "C" int crd_fused_erk_step_info(int f64, int kinetics, int* out) {
  return f64 ? info<double>(kinetics, out) : info<float>(kinetics, out);
}
