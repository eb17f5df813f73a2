// Kernel K2 (fused_rkc.cu), profile branch, for the six kinetics families
// beyond the base three: Barkley, the Oregonator, Gray-Scott, the
// Brusselator, lambda-omega and SIR (ops/kernel_common.py::NEW_FAMILIES),
// unforced. Compiled apart from fused_rkc.cu, so that the build compiles
// these instantiations beside the others. K2b (the JAX package's
// column-blocked layout) is this same step at its shapes.
//
// Replaces the same TPU kernel as fused_rkc.cu's profile branch
// (crdmodel_tpu/ops/pallas_rkc.py::build_fused_rkc_step and
// ::_build_blocked), whose tile body traces any family.
//
// Design: rkc_chunk.cuh's chunked scheme (fused_rkc_chunk_n_kernel): the
// s + 1 evaluations in chunks of at most 6 over 32x32 tiles, one
// cooperative launch, the recurrence carrying every variable (Yj-1 and
// Yj-2 of each in its thread's registers, y0 and F0 of each in shared
// memory), the stencil on each diffusing variable's shared plane of Yj-1,
// times its ratio after the stencil. `work` holds 5 nvars planes. y_new
// and every partial sum are bitwise the plain version's
// (ops/fused_rkc.py::fused_rkc_step_reference, fused_rkc_tile_sums).

#include <cuda_runtime.h>

#include "rhs_common.cuh"
#include "rkc_chunk.cuh"

namespace {

template <typename T>
int launch(const void* y, void* y_new, void* ss, void* work, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* s, const void* mu1_tab, const void* ctab, int s_cap,
           const void* c0, const void* c1, const void* c2, int torus,
           const void* ae, const void* aw, const void* an,
           const void* tissue, const void* beta, int beta_field,
           const void* mask, int has_freeze, int kinetics, int ny, int nx,
           double rtol, double atol, void* stream) {
  // unforced, on the profile operator only
  if (n_stim != 0 || amps != nullptr || rows != nullptr || cols != nullptr
      || ae != nullptr || aw != nullptr || an != nullptr
      || tissue != nullptr || c0 == nullptr || ny < 1 || nx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)n_cols;
  (void)var1;
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const crd::WrapGrid wg{ny, nx};
  const int tiles_x = (nx + crd::kRkcTile - 1) / crd::kRkcTile;
  const int n_tiles = tiles_x * ((ny + crd::kRkcTile - 1) / crd::kRkcTile);
  const crd::RkcPlan plan = {ny,      nx,      crd::kRkcTile, crd::kRkcTile,
                             tiles_x, n_tiles};
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    constexpr int Kin = decltype(kin)::value;
    return crd::launch_rkc_chunk_n<Kin, crd::WrapGrid, T>(
        crd::FamilyRhs<Kin, T>{k}, wg, plan, n_tiles, y, y_new, ss, work, h,
        fz, s, mu1_tab, ctab, s_cap, rtol, atol, stream);
  });
}

template <typename T>
int info(int kinetics, int* out) {
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    return crd::rkc_chunk_n_info<decltype(kin)::value, crd::WrapGrid, T>(
        out);
  });
}

}  // namespace

// crd_fused_rkc_step's arguments (fused_rkc.cu); the forcing's and the
// divergence form's must be null and 0; work: 5 nvars planes of the
// state's shape
#define CRD_FUSED_RKC_ARGS                                                   \
  const void *y, void *y_new, void *ss, void *work, const void *h,           \
      const void *fz, const void *amps, const void *rows, const void *cols,  \
      int n_stim, int n_cols, int var1, const void *s, const void *mu1_tab,  \
      const void *ctab, int s_cap, const void *c0, const void *c1,           \
      const void *c2, int torus, const void *ae, const void *aw,             \
      const void *an, const void *tissue, const void *beta, int beta_field,  \
      const void *mask, int has_freeze, int kinetics, int ny, int nx,        \
      double rtol, double atol, void *stream
#define CRD_FUSED_RKC_PASS                                                   \
  y, y_new, ss, work, h, fz, amps, rows, cols, n_stim, n_cols, var1, s,      \
      mu1_tab, ctab, s_cap, c0, c1, c2, torus, ae, aw, an, tissue, beta,     \
      beta_field, mask, has_freeze, kinetics, ny, nx, rtol, atol, stream

extern "C" int crd_fused_rkc_step_families_f32(CRD_FUSED_RKC_ARGS) {
  return launch<float>(CRD_FUSED_RKC_PASS);
}

extern "C" int crd_fused_rkc_step_families_f64(CRD_FUSED_RKC_ARGS) {
  return launch<double>(CRD_FUSED_RKC_PASS);
}

// out[3] of a family's kernel (crd_fused_rkc_info's)
extern "C" int crd_fused_rkc_families_info(int f64, int kinetics, int* out) {
  return f64 ? info<double>(kinetics, out) : info<float>(kinetics, out);
}
