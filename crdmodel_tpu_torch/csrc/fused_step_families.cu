// Kernel K1 (fused_step.cu) for the six kinetics families beyond the base
// three: Barkley, the Oregonator, Gray-Scott, the Brusselator,
// lambda-omega and SIR (ops/kernel_common.py::NEW_FAMILIES), unforced, on
// the 5-point profile operator. Compiled apart from fused_step.cu, so that
// the build compiles these instantiations beside the others.
//
// Replaces the same TPU kernel as fused_step.cu
// (crdmodel_tpu/ops/pallas_step.py::build_fused_step), whose tile body
// traces any family: each diffusing variable's operator, times its ratio
// after the stencil (pallas kernel_common.py:139-159).
//
// Design: bs32 on erk_slots.cuh's register-resident scheme
// (fused_erk_slots_n_kernel: 512 threads fixed to a 32x32 tile and its
// rings, every variable of a point's stage inputs and error in its
// thread's registers, a pair of shared stage planes for each diffusing
// variable), zonneveld43 and dopri54 on erk_tile.cuh's scheme
// (fused_erk_tile_n_kernel, every stage of every variable in shared
// memory, on ops/fused_step.py::tile_plan's tiles for the family's
// variables). The right-hand side is rhs_common.cuh::FamilyRhs, the
// family a template parameter. y_new and every partial sum are bitwise the
// plain version's (ops/fused_step.py::fused_step_reference,
// fused_step_tile_sums), which the library's -fmad=false keeps.

#include <cuda_runtime.h>

#include "erk_slots.cuh"
#include "rhs_common.cuh"

namespace {

template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* c0, const void* c1, const void* c2, int torus,
           const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int ny, int nx, int tile_x,
           int tile_y, int n_stages, const double* a, const double* b,
           const double* d, double rtol, double atol, void* stream) {
  crd::StageTable tab;
  // the families' instantiations are unforced
  if (n_stim != 0 || amps != nullptr || rows != nullptr || cols != nullptr
      || !crd::make_stage_table(n_stages, a, b, d, &tab))
    return static_cast<int>(cudaErrorInvalidValue);
  (void)n_cols;
  (void)var1;
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const crd::WrapGrid grid = {ny, nx};
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    constexpr int Kin = decltype(kin)::value;
    return crd::launch_erk_slots_n<Kin, T>(crd::FamilyRhs<Kin, T>{k}, grid,
                                           y, y_new, ss, h, fz, ny, nx,
                                           tile_x, tile_y, tab, rtol, atol,
                                           stream);
  });
}

template <typename T>
int info(int kinetics, int* out) {
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    return crd::slots_n_kernel_info<decltype(kin)::value, crd::WrapGrid,
                                    T>(out);
  });
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

// crd_fused_erk_step's arguments (fused_step.cu); the forcing's must be
// null and 0
extern "C" int crd_fused_erk_step_families_f32(CRD_FUSED_STEP_ARGS) {
  return launch<float>(CRD_FUSED_STEP_PASS);
}

extern "C" int crd_fused_erk_step_families_f64(CRD_FUSED_STEP_ARGS) {
  return launch<double>(CRD_FUSED_STEP_PASS);
}

// out[3] of the bs32 kernel of a family (crd_fused_erk_step_info's)
extern "C" int crd_fused_erk_step_families_info(int f64, int kinetics,
                                                int* out) {
  return f64 ? info<double>(kinetics, out) : info<float>(kinetics, out);
}
