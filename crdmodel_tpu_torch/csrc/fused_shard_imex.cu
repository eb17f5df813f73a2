// Fused IMEX ARK3(2)4L[2]SA step of the 5-point profile operator (explicit)
// and pointwise FitzHugh-Nagumo, Goldbeter or Aliev-Panfilov kinetics
// (implicit) on one shard of a 2-D mesh (kernel K10 of the port).
//
// Replaces crdmodel_tpu/ops/pallas_shard_imex.py::build_fused_shard_imex,
// the Pallas TPU kernel that takes every attempted step of a sharded ark324
// run. It is K3 (fused_imex.cu) on one shard: one exchange of width P >= 4 a
// step (parallel/halo.py::refresh_halos) fills the halo of the shard's
// buffer, and one launch computes the 4 explicit stencil evaluations, the 3
// implicit stages by full Newton at every point (pointwise, so shard-local:
// no exchange beyond the step's one), the update, and one partial sum per
// thread block of the squared WRMS-scaled error plus (1/NEWTON_TOL)^2 times
// the squared scaled last Newton updates, both over the PHYSICAL cells. The
// caller adds every shard's partials in a fixed order, so the Newton
// convergence test rides the error's cross-shard sum and every shard takes
// the same accept/reject decision.
//
// Design: imex_slots.cuh's register-resident scheme with the HaloGrid
// policy (tile_slots.cuh::SlotOrigin): 512 threads fixed to a 32x32 tile
// (two points each) and its Newton rings (at most one point each), the
// rhs_known of the later stages, the predictor's kI and the tile's update
// and error sums in registers; y0's u and the stage value of variable 0
// in three shared planes of the 40x40 region; a full tile's region lies
// inside the buffer (the exchange's 8 >= 4 rings) and takes code without
// the clamp. The RHS indexes the shard's halo-padded constants (three
// (nxl + 2P) profiles or three scalars, beta and the freeze mask as
// (nyl + 2P) rows). On a mesh that does not divide the grid the kernel
// runs the JAX kernels' mirror-pad semantics: pad cells step like their
// wrapped sources, and only the first valid_rows x valid_cols cells of the
// block enter either part of the sum. Only the block of y_new is written.
// The partial sums replay the 256-thread order of K3's first port, so
// y_new and every partial sum are bitwise the plain version's and that
// kernel's, and a run takes the same steps.
//
// What bounds it on an H100: the Newton's arithmetic, some 500 flops and
// 70 IEEE divisions a point for Goldbeter (10.15 us at (2,1616,416) at 67
// TFLOP/s), on 1.27x the tile's points (the Newton's rings); the buffer is
// read once and y_new's block written once. Each thread carries at most
// three points through the stages, where the first port's 256 threads
// carried some six each through shared memory.
//
// A structured forcing (pallas_shard_imex.py:90-124, 147-155, 243-255)
// rides the explicit stages only, as K3's (fused_imex.cu): an amplitude
// table amps[n_stim][4] at the ARK's c nodes, computed on the device
// before the launch, and each stimulus's row and column profiles
// halo-padded to the shard's buffer (ops/kernel_common.py::
// prepare_shard_stim_constants), read at the buffer's (r, c) a point's
// state comes from (imex_slots.cuh, rhs_common.cuh::StimTable). n_stim = 0
// takes the unforced instantiation (NoStim).

#include <cuda_runtime.h>

#include "imex_slots.cuh"
#include "rhs_common.cuh"

namespace {

// amps, rows, cols, n_stim, n_cols, var1: the structured forcing of the
// explicit stages, its profiles halo-padded to the buffer (n_stim = 0 and
// null pointers without one)
template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* c0, const void* c1, const void* c2,
           int torus, const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int nyl, int nxl, int halo,
           int valid_rows, int valid_cols, int tile_x, int tile_y,
           const double* ae, const double* ai, const double* b,
           const double* d, double gamma, double rtol, double atol,
           void* stream) {
  if (halo < crd::kImexHalo || valid_rows < 0 || valid_rows > nyl
      || valid_cols < 0 || valid_cols > nxl)
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  if (tile_x != crd::kImexTile || tile_y != crd::kImexTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::HaloGrid grid = {nyl, nxl, halo, valid_rows, valid_cols};
  const crd::ImexTable tab = crd::make_imex_table(ae, ai, b, d, gamma);
  return crd::with_stim<T>(
      amps, rows, cols, n_stim, n_cols, var1, n_cols == crd::kImexStages,
      nyl + 2 * halo, nxl + 2 * halo, [&](auto stim) {
        return crd::launch_imex_slots<crd::HaloGrid, T, crd::kImexTile>(
            grid, y, y_new, ss, h, fz, k, kinetics, nyl, nxl, tab, rtol,
            atol, stream, stim);
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

extern "C" int crd_fused_shard_imex_step_f32(CRD_FUSED_SHARD_IMEX_ARGS) {
  return launch<float>(CRD_FUSED_SHARD_IMEX_PASS);
}

extern "C" int crd_fused_shard_imex_step_f64(CRD_FUSED_SHARD_IMEX_ARGS) {
  return launch<double>(CRD_FUSED_SHARD_IMEX_PASS);
}

extern "C" int crd_fused_shard_imex_info(int f64, int kinetics, int* out) {
  return f64 ? crd::imex_slots_info<crd::HaloGrid, double, crd::kImexTile>(
                   kinetics, out)
             : crd::imex_slots_info<crd::HaloGrid, float, crd::kImexTile>(
                   kinetics, out);
}
