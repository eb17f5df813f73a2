// Kernel K10 (fused_shard_imex.cu) for the six kinetics families beyond
// the base three: Barkley, the Oregonator, Gray-Scott, the Brusselator,
// lambda-omega and SIR (ops/kernel_common.py::NEW_FAMILIES; SIR with three
// variables), unforced, one shard's block in the halo the exchange filled.
// Compiled apart from fused_shard_imex.cu, so that the build compiles these
// instantiations beside the others.
//
// Replaces the same TPU kernel as fused_shard_imex.cu
// (crdmodel_tpu/ops/pallas_shard_imex.py::build_fused_shard_imex), whose
// tile body traces any family and differentiates its kinetics in the
// kernel.
//
// Design: K3's family kernel (fused_imex_families.cu) with the HaloGrid
// policy (imex_slots.cuh::fused_imex_slots_n_kernel<Kin, HaloGrid, T, 32>)
// on K10's 32x32 tiles: every variable of a slot's pointwise state in its
// thread's registers, y0 and the stage value of each diffusing variable in
// shared planes of the 40x40 region, which lies inside the buffer for a
// full tile (the exchange's 8 >= 4 rings, every variable exchanged), the
// explicit part each diffusing variable's operator times its ratio, and
// the shard-local Newton on the family's closed-form Jacobian, solved by
// Cramer's rule, 2x2 or 3x3 (SIR), in the torch path's order. Mirror-pad
// cells step like their sources and add +0.0 to both parts of the sums,
// which replay K3's 256-thread order: y_new's block and every partial sum
// are bitwise the plain version's (ops/fused_shard_imex.py::
// fused_shard_imex_step_reference, fused_shard_imex_tile_sums).

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
           int has_freeze, int kinetics, int nyl, int nxl, int halo,
           int valid_rows, int valid_cols, int tile_x, int tile_y,
           const double* ae, const double* ai, const double* b,
           const double* d, double gamma, double rtol, double atol,
           void* stream) {
  // unforced, on K10's square tiles
  if (n_stim != 0 || amps != nullptr || rows != nullptr || cols != nullptr
      || halo < crd::kImexHalo || valid_rows < 0 || valid_rows > nyl
      || valid_cols < 0 || valid_cols > nxl || tile_x != crd::kImexTile
      || tile_y != crd::kImexTile)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)n_cols;
  (void)var1;
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const crd::HaloGrid grid = {nyl, nxl, halo, valid_rows, valid_cols};
  const crd::ImexTable tab = crd::make_imex_table(ae, ai, b, d, gamma);
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    return crd::launch_imex_slots_n<decltype(kin)::value, T,
                                    crd::kImexTile>(
        grid, y, y_new, ss, h, fz, k, nyl, nxl, tab, rtol, atol, stream);
  });
}

template <typename T>
int info(int kinetics, int* out) {
  return crd::with_kinetics_in(crd::NewFamilies{}, kinetics, [&](auto kin) {
    return crd::imex_slots_n_info<decltype(kin)::value, crd::HaloGrid, T,
                                  crd::kImexTile>(out);
  });
}

}  // namespace

#define CRD_FUSED_SHARD_IMEX_ARGS                                            \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,       \
      const void *amps, const void *rows, const void *cols, int n_stim,      \
      int n_cols, int var1, const void *c0, const void *c1, const void *c2,  \
      int torus, const void *beta, int beta_field, const void *mask,         \
      int has_freeze, int kinetics, int nyl, int nxl, int halo,              \
      int valid_rows, int valid_cols, int tile_x, int tile_y,                \
      const double *ae, const double *ai, const double *b, const double *d,  \
      double gamma, double rtol, double atol, void *stream
#define CRD_FUSED_SHARD_IMEX_PASS                                            \
  y, y_new, ss, h, fz, amps, rows, cols, n_stim, n_cols, var1, c0, c1,       \
      c2, torus, beta, beta_field, mask, has_freeze, kinetics, nyl, nxl,     \
      halo, valid_rows, valid_cols, tile_x, tile_y, ae, ai, b, d, gamma,     \
      rtol, atol, stream

// crd_fused_shard_imex_step's arguments (fused_shard_imex.cu); the
// forcing's must be null and 0
extern "C" int crd_fused_shard_imex_step_families_f32(
    CRD_FUSED_SHARD_IMEX_ARGS) {
  return launch<float>(CRD_FUSED_SHARD_IMEX_PASS);
}

extern "C" int crd_fused_shard_imex_step_families_f64(
    CRD_FUSED_SHARD_IMEX_ARGS) {
  return launch<double>(CRD_FUSED_SHARD_IMEX_PASS);
}

// out[3] of a family's kernel (crd_fused_shard_imex_info's)
extern "C" int crd_fused_shard_imex_families_info(int f64, int kinetics,
                                                  int* out) {
  return f64 ? info<double>(kinetics, out) : info<float>(kinetics, out);
}
