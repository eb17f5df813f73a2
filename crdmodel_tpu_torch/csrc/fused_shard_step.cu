// Fused embedded-ERK step of the 5-point profile operator on one shard of a
// 2-D mesh, with FitzHugh-Nagumo, Goldbeter or Aliev-Panfilov kinetics
// (kernel K8 of the port).
//
// Replaces crdmodel_tpu/ops/pallas_shard_step.py::build_fused_shard_step,
// the Pallas TPU kernel that takes every attempted step of a sharded ERK
// run (the JAX package's multi-chip hot path). It is K1 (fused_step.cu) on
// one shard: one exchange of width P >= n_stages a step
// (parallel/halo.py::refresh_halos) fills the halo of the shard's buffer,
// and one launch computes every stage, the solution update, and one partial
// sum of squared WRMS-scaled errors per thread block over the PHYSICAL
// cells. The caller adds every shard's partials in a fixed order, so every
// shard takes the same accept/reject decision.
//
// The tile scheme is K1's with the HaloGrid policy (rhs_common.cuh): the
// tile reads its n_stages-ring region from the buffer, no index wraps (the
// wrap is the exchange's job), and the RHS indexes the shard's halo-padded
// constants (three (nxl + 2P) profiles or three scalars, beta and the
// freeze mask as (nyl + 2P) rows). bs32, the main path's tableau, takes
// erk_slots.cuh's register-resident scheme (SlotOrigin<HaloGrid>): the
// exchange filled P = 8 >= n rings, so a full tile's region lies inside
// the buffer and takes code without the clamp; only the partial tiles at
// the block's last rows and columns clamp. zonneveld43 and dopri54 take
// erk_tile.cuh's scheme, by the launcher's dispatch on the stage count
// (launch_erk_slots_on). On a mesh that does not divide the grid the kernel
// runs the JAX kernels' mirror-pad semantics: pad cells step like their
// wrapped sources, whose constants they carry, and only the first
// valid_rows x valid_cols cells of the block enter the error sum. Only the
// block of y_new is written; its halo is the next exchange's. Each partial
// sum adds its tile's points in erk_tile.cuh's order, so y_new's block and
// every partial sum are bitwise those of the plain version and of
// erk_tile.cuh's scheme.
//
// What bounds it on an H100: the shard's buffer (2 x (nyl+2P) x (nxl+2P)) is
// read once and y_new's block written once, as for K1 (about 2.7 MB a bs32
// step on the canonical torus's (816,216) shard in f32, 0.8 us at 3.35
// TB/s): a step is bound by latency and issue, and by the host's launches
// and halo copies around the kernel. The design is K1's: a point's stage
// inputs, error and coefficients in its thread's registers, read once a
// launch (ProfileRhs::point), the stage input's variable 0 in two shared
// planes, one block barrier a stage.
//
// A structured forcing (pallas_shard_step.py:149-230, 281-288, 331-352)
// comes in as K1's does (fused_step.cu): an amplitude table
// amps[n_stim][n_stages], computed on the device before the launch, and
// each stimulus's row and column profiles, here halo-padded to the
// shard's buffer (nyl + 2P and nxl + 2P entries, the exchange's values
// and, on a padded mesh, the mirror-pad cells' sources':
// ops/kernel_common.py::prepare_shard_stim_constants). A point reads them
// at the buffer's (r, c) its state comes from (HaloGrid's row and col),
// through rhs_common.cuh::StimTable; n_stim = 0 takes the unforced
// instantiation (NoStim), which has none of it.

#include <cuda_runtime.h>

#include "erk_slots.cuh"
#include "rhs_common.cuh"

namespace {

using crd::HaloGrid;
using crd::ProfileRhs;

// amps, rows, cols, n_stim, n_cols, var1: the structured forcing, its
// profiles halo-padded to the buffer (n_stim = 0 and null pointers
// without one)
template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* c0, const void* c1, const void* c2,
           int torus, const void* beta, int beta_field, const void* mask,
           int has_freeze, int kinetics, int nyl, int nxl, int halo,
           int valid_rows, int valid_cols, int tile_x, int tile_y,
           int n_stages, const double* a, const double* b, const double* d,
           double rtol, double atol, void* stream) {
  crd::StageTable tab;
  if (!crd::make_stage_table(n_stages, a, b, d, &tab)
      || !crd::valid_kinetics(kinetics) || halo < n_stages
      || valid_rows < 0 || valid_rows > nyl || valid_cols < 0
      || valid_cols > nxl)
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const HaloGrid grid = {nyl, nxl, halo, valid_rows, valid_cols};
  return crd::with_stim<T>(
      amps, rows, cols, n_stim, n_cols, var1, n_cols == n_stages,
      nyl + 2 * halo, nxl + 2 * halo, [&](auto stim) {
        return crd::with_kinetics(kinetics, [&](auto kin) {
          return crd::launch_erk_slots_on<
              ProfileRhs<decltype(kin)::value, T>, T>(
              {k}, grid, y, y_new, ss, h, fz, nyl, nxl, tile_x, tile_y, tab,
              rtol, atol, stream, stim);
        });
      });
}

// crd::slots_kernel_info of the bs32 kernel of `kinetics` in T
template <typename T>
int info(int kinetics, int* out) {
  if (kinetics == crd::kFhn)
    return crd::slots_kernel_info<ProfileRhs<crd::kFhn, T>, HaloGrid, T>(out);
  if (kinetics == crd::kGoldbeter)
    return crd::slots_kernel_info<ProfileRhs<crd::kGoldbeter, T>, HaloGrid,
                                  T>(out);
  if (kinetics == crd::kAlievPanfilov)
    return crd::slots_kernel_info<ProfileRhs<crd::kAlievPanfilov, T>,
                                  HaloGrid, T>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define CRD_FUSED_SHARD_STEP_ARGS                                            \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,       \
      const void *amps, const void *rows, const void *cols, int n_stim,      \
      int n_cols, int var1, const void *c0, const void *c1,                  \
      const void *c2, int torus, const void *beta, int beta_field,           \
      const void *mask, int has_freeze, int kinetics, int nyl, int nxl,      \
      int halo, int valid_rows, int valid_cols, int tile_x, int tile_y,      \
      int n_stages,                                                          \
      const double *a, const double *b, const double *d, double rtol,        \
      double atol, void *stream
#define CRD_FUSED_SHARD_STEP_PASS                                            \
  y, y_new, ss, h, fz, amps, rows, cols, n_stim, n_cols, var1, c0, c1,       \
      c2, torus, beta, beta_field, mask, has_freeze, kinetics, nyl, nxl,     \
      halo, valid_rows, valid_cols, tile_x, tile_y, n_stages, a, b, d,       \
      rtol, atol, stream

extern "C" int crd_fused_shard_step_f32(CRD_FUSED_SHARD_STEP_ARGS) {
  return launch<float>(CRD_FUSED_SHARD_STEP_PASS);
}

extern "C" int crd_fused_shard_step_f64(CRD_FUSED_SHARD_STEP_ARGS) {
  return launch<double>(CRD_FUSED_SHARD_STEP_PASS);
}

extern "C" int crd_fused_shard_step_info(int f64, int kinetics, int* out) {
  return f64 ? info<double>(kinetics, out) : info<float>(kinetics, out);
}
