// Kernel K3 (fused_imex.cu) for the six kinetics families beyond the base
// three: Barkley, the Oregonator, Gray-Scott, the Brusselator,
// lambda-omega and SIR (ops/kernel_common.py::NEW_FAMILIES), unforced.
// Compiled apart from fused_imex.cu, so that the build compiles these
// instantiations beside the others.
//
// Replaces the same TPU kernel as fused_imex.cu
// (crdmodel_tpu/ops/pallas_imex.py::build_fused_imex_step), whose tile
// body traces any family and differentiates its kinetics in the kernel.
//
// Design: imex_slots.cuh's register-resident scheme
// (fused_imex_slots_n_kernel) on the plan sized to the grid
// (ops/fused_imex.py::slots_plan): every variable of a slot's pointwise
// state in its thread's registers, y0 and the stage value of each
// diffusing variable in shared planes, the explicit part each diffusing
// variable's operator times its ratio, and the implicit Newton on the
// family's closed-form Jacobian (rhs_common.cuh::jacobian_n), solved by
// Cramer's rule, 2x2 or 3x3 (SIR), in the torch path's order. y_new and
// every partial sum are bitwise the plain version's (ops/fused_imex.py::
// fused_imex_step_reference, fused_imex_tile_sums).

#include <cuda_runtime.h>

#include "imex_slots.cuh"
#include "rhs_common.cuh"

namespace {

template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* c0, const void* c1, const void* c2, int torus,
           const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int ny, int nx, int tile_x,
           int tile_y, const double* ae, const double* ai, const double* b,
           const double* d, double gamma, double rtol, double atol,
           void* stream) {
  // unforced
  if (n_stim != 0 || amps != nullptr || rows != nullptr || cols != nullptr
      || tile_x != crd::kImexTile)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)n_cols;
  (void)var1;
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const crd::WrapGrid grid = {ny, nx};
  const crd::ImexTable tab = crd::make_imex_table(ae, ai, b, d, gamma);
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    constexpr int Kin = decltype(kin)::value;
    if (tile_y == 32)
      return crd::launch_imex_slots_n<Kin, T, 32>(grid, y, y_new, ss, h, fz,
                                                  k, ny, nx, tab, rtol, atol,
                                                  stream);
    if (tile_y == 16)
      return crd::launch_imex_slots_n<Kin, T, 16>(grid, y, y_new, ss, h, fz,
                                                  k, ny, nx, tab, rtol, atol,
                                                  stream);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

template <typename T>
int info(int kinetics, int tile_y, int* out) {
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    constexpr int Kin = decltype(kin)::value;
    if (tile_y == 32)
      return crd::imex_slots_n_info<Kin, crd::WrapGrid, T, 32>(out);
    if (tile_y == 16)
      return crd::imex_slots_n_info<Kin, crd::WrapGrid, T, 16>(out);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

}  // namespace

#define CRD_FUSED_IMEX_ARGS                                                  \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,       \
      const void *amps, const void *rows, const void *cols, int n_stim,      \
      int n_cols, int var1, const void *c0, const void *c1,                  \
      const void *c2, int torus, const void *beta, int beta_field,           \
      const void *mask, int has_freeze, int kinetics, int ny, int nx,        \
      int tile_x, int tile_y, const double *ae, const double *ai,            \
      const double *b, const double *d, double gamma, double rtol,           \
      double atol, void *stream
#define CRD_FUSED_IMEX_PASS                                                  \
  y, y_new, ss, h, fz, amps, rows, cols, n_stim, n_cols, var1, c0, c1,       \
      c2, torus, beta, beta_field, mask, has_freeze, kinetics, ny, nx,       \
      tile_x, tile_y, ae, ai, b, d, gamma, rtol, atol, stream

// crd_fused_imex_step's arguments (fused_imex.cu); the forcing's must be
// null and 0
extern "C" int crd_fused_imex_step_families_f32(CRD_FUSED_IMEX_ARGS) {
  return launch<float>(CRD_FUSED_IMEX_PASS);
}

extern "C" int crd_fused_imex_step_families_f64(CRD_FUSED_IMEX_ARGS) {
  return launch<double>(CRD_FUSED_IMEX_PASS);
}

// out[3] of a family's kernel on 32 x tile_y tiles (crd_fused_imex_info's)
extern "C" int crd_fused_imex_families_info(int f64, int kinetics,
                                            int tile_y, int* out) {
  return f64 ? info<double>(kinetics, tile_y, out)
             : info<float>(kinetics, tile_y, out);
}
