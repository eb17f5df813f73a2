// Kernel K8 (fused_shard_step.cu) for the six kinetics families beyond the
// base three: Barkley, the Oregonator, Gray-Scott, the Brusselator,
// lambda-omega and SIR (ops/kernel_common.py::NEW_FAMILIES), unforced, on
// the 5-point profile operator, one shard's block in the halo the exchange
// filled. Compiled apart from fused_shard_step.cu, so that the build
// compiles these instantiations beside the others.
//
// Replaces the same TPU kernel as fused_shard_step.cu
// (crdmodel_tpu/ops/pallas_shard_step.py::build_fused_shard_step), whose
// tile body traces any family (pallas kernel_common.py:110-159): each
// diffusing variable's operator, times its ratio after the stencil.
//
// Design: K1's family kernels (fused_step_families.cu) with the HaloGrid
// policy: bs32 on erk_slots.cuh's register-resident scheme
// (fused_erk_slots_n_kernel<Kin, HaloGrid, T>: 512 threads fixed to a
// 32x32 tile and its rings, every variable of a point's stage inputs and
// error in its thread's registers, a pair of shared stage planes for each
// diffusing variable; the exchange's 8 >= 4 rings put a full tile's region
// inside the buffer, so it takes code without the clamp), zonneveld43 and
// dopri54 on erk_tile.cuh's scheme (fused_erk_tile_n_kernel<Kin, HaloGrid,
// T>, on ops/fused_step.py::tile_plan's tiles for the family's
// variables). The right-hand side is rhs_common.cuh::FamilyRhs on the
// shard's halo-padded constants. On a mesh that does not divide the grid,
// pad cells step like their sources and add +0.0 to the sums. y_new's
// block and every partial sum are bitwise the plain version's
// (ops/fused_shard_step.py::fused_shard_step_reference,
// fused_shard_step_tile_sums), which the library's -fmad=false keeps.

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
           int has_freeze, int kinetics, int nyl, int nxl, int halo,
           int valid_rows, int valid_cols, int tile_x, int tile_y,
           int n_stages, const double* a, const double* b, const double* d,
           double rtol, double atol, void* stream) {
  crd::StageTable tab;
  // the families' instantiations are unforced
  if (n_stim != 0 || amps != nullptr || rows != nullptr || cols != nullptr
      || !crd::make_stage_table(n_stages, a, b, d, &tab)
      || halo < n_stages || valid_rows < 0 || valid_rows > nyl
      || valid_cols < 0 || valid_cols > nxl)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)n_cols;
  (void)var1;
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const crd::HaloGrid grid = {nyl, nxl, halo, valid_rows, valid_cols};
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    constexpr int Kin = decltype(kin)::value;
    return crd::launch_erk_slots_n<Kin, T>(crd::FamilyRhs<Kin, T>{k}, grid,
                                           y, y_new, ss, h, fz, nyl, nxl,
                                           tile_x, tile_y, tab, rtol, atol,
                                           stream);
  });
}

template <typename T>
int info(int kinetics, int* out) {
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    return crd::slots_n_kernel_info<decltype(kin)::value, crd::HaloGrid,
                                    T>(out);
  });
}

}  // namespace

#define CRD_FUSED_SHARD_STEP_ARGS                                            \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,       \
      const void *amps, const void *rows, const void *cols, int n_stim,      \
      int n_cols, int var1, const void *c0, const void *c1,                  \
      const void *c2, int torus, const void *beta, int beta_field,           \
      const void *mask, int has_freeze, int kinetics, int nyl, int nxl,      \
      int halo, int valid_rows, int valid_cols, int tile_x, int tile_y,      \
      int n_stages, const double *a, const double *b, const double *d,       \
      double rtol, double atol, void *stream
#define CRD_FUSED_SHARD_STEP_PASS                                            \
  y, y_new, ss, h, fz, amps, rows, cols, n_stim, n_cols, var1, c0, c1,       \
      c2, torus, beta, beta_field, mask, has_freeze, kinetics, nyl, nxl,     \
      halo, valid_rows, valid_cols, tile_x, tile_y, n_stages, a, b, d,       \
      rtol, atol, stream

// crd_fused_shard_step's arguments (fused_shard_step.cu); the forcing's
// must be null and 0
extern "C" int crd_fused_shard_step_families_f32(CRD_FUSED_SHARD_STEP_ARGS) {
  return launch<float>(CRD_FUSED_SHARD_STEP_PASS);
}

extern "C" int crd_fused_shard_step_families_f64(CRD_FUSED_SHARD_STEP_ARGS) {
  return launch<double>(CRD_FUSED_SHARD_STEP_PASS);
}

// out[3] of the bs32 kernel of a family (crd_fused_shard_step_info's)
extern "C" int crd_fused_shard_step_families_info(int f64, int kinetics,
                                                  int* out) {
  return f64 ? info<double>(kinetics, out) : info<float>(kinetics, out);
}
