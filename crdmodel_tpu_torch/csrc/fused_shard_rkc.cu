// Fused RKC2 step of the 5-point profile operator on one shard of a 2-D
// mesh, with FitzHugh-Nagumo, Goldbeter or Aliev-Panfilov kinetics (kernel
// K9 of the port).
//
// Replaces crdmodel_tpu/ops/pallas_shard_rkc.py::build_fused_shard_rkc, the
// Pallas TPU kernel that takes every attempted step of a sharded rkc2 run
// (the JAX package's production multi-chip configuration for
// diffusion-limited large grids). It is K2's profile branch (fused_rkc.cu)
// on one shard: one exchange of width P = 24 = S_MAX_KERNEL + 1 a step
// (parallel/halo.py::refresh_halos) fills the halo of the shard's buffer,
// and one launch computes all s Chebyshev stages, y_new and the partial
// sums of squared WRMS-scaled errors over the PHYSICAL cells. The caller
// max-reduces the spectral-radius bound across the shards before s is
// chosen, so every shard runs the same s and the same table rows, and adds
// every shard's partials in a fixed order.
//
// Design: K2's kernel (rkc_chunk.cuh) with the HaloGrid policy: the s + 1
// evaluations in chunks of at most 6, each a pass over 32x32 tiles with a
// halo as deep as the chunk, one persistent cooperative launch with a grid
// barrier between chunks, a point's recurrence values in its thread's
// registers. The exchange's P >= s + 1 rings hold the block's whole cone
// of dependence, so the chunks need no exchange of their own: chunk c's
// tiles cover the block grown by the s + 1 - e1 evaluations still to come,
// the rings beyond it going wrong from the buffer's edge inwards without
// reaching the block. Mirror-pad cells of a mesh that does not divide the
// grid step like their sources and stay out of the error sum, as in K8
// (fused_shard_step.cu). Only the block of y_new is written. The partial
// sums are the one-pass tile kernel's that this step first ran on: one a
// tile of ops/fused_rkc.py::tile_plan (32x32 in f32, 16x8 in f64),
// anchored at the block's first cell, each added in that kernel's
// 512-thread order, so that a run takes the same steps.
//
// What bounds it on an H100: the buffer read once and y_new's block
// written once whatever s, the shard's constants read once (12.7 us at
// (2,3248,848) in f32, 3.35 TB/s); at s = 23 the s + 1 right-hand sides a
// point bound it (34.5 us at 67 TFLOP/s). The chunked scheme computes at
// most 24 x 44^2 evaluations a tile at s = 23 (an evaluation skips the
// rows outside its depth) where the one-pass tile computed 77,200, at two
// blocks an SM, the operator's coefficients staged in shared memory once
// a tile; what is left over the bound is the chunks' halo (up to 1.9x at
// 6 rings), the grid barriers and the hand-off through device memory (12
// planes of the buffer a chunk boundary).
//
// A structured forcing (pallas_shard_rkc.py:54-57, 123-160, 191-199,
// 335-356) comes in as K2's (fused_rkc.cu): an amplitude table
// amps[n_stim][n_cols], one column when every stimulus is segment-gated,
// else S_MAX_KERNEL + 2 at the Chebyshev stage times of the s all shards
// run, computed on the device before the launch; evaluation e reads column
// rkc_amp_column(e) whichever chunk runs it. Each stimulus's row and
// column profiles are halo-padded to the shard's P = 24 rings
// (ops/kernel_common.py::prepare_shard_stim_constants) and read at the
// buffer's (r, c) a point's state comes from (rkc_chunk.cuh's
// ChunkOrigin<HaloGrid>). n_stim = 0 takes the unforced instantiation.

#include <cuda_runtime.h>

#include "rhs_common.cuh"
#include "rkc_chunk.cuh"

namespace {

using crd::HaloGrid;
using crd::ProfileRhs;

// The most tiles a chunk of a step of at most s_cap stages has on an
// nyl x nxl block: its extent grows by the evaluations still to come after
// the first chunk (rkc_chunk.cuh::extent_rings).
// amps, rows, cols, n_stim, n_cols, var1: the structured forcing, its
// profiles halo-padded to the buffer (n_stim = 0 and null pointers
// without one)
template <typename T>
int launch(const void* y, void* y_new, void* ss, void* work, const void* h,
           const void* fz, const void* amps, const void* rows,
           const void* cols, int n_stim, int n_cols, int var1,
           const void* s, const void* mu1_tab,
           const void* ctab, int s_cap, const void* c0, const void* c1,
           const void* c2, int torus, const void* beta, int beta_field,
           const void* mask, int has_freeze, int kinetics, int nyl, int nxl,
           int halo, int valid_rows, int valid_cols, int sum_tx, int sum_ty,
           double rtol, double atol, void* stream) {
  if (s_cap < 2 || s_cap > crd::kRkcMaxStages || halo < s_cap + 1
      || nyl < 1 || nxl < 1 || sum_tx < 1 || sum_ty < 1
      || !crd::valid_kinetics(kinetics) || valid_rows < 0
      || valid_rows > nyl || valid_cols < 0 || valid_cols > nxl)
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const HaloGrid grid = {nyl, nxl, halo, valid_rows, valid_cols};
  const int sums_x = (nxl + sum_tx - 1) / sum_tx;
  const crd::RkcPlan plan = {nyl,    nxl,    sum_tx,
                             sum_ty, sums_x, sums_x * ((nyl + sum_ty - 1)
                                                       / sum_ty)};
  const int most = crd::halo_max_tiles(s_cap, nyl, nxl);
  return crd::with_stim<T>(
      amps, rows, cols, n_stim, n_cols, var1,
      n_cols == 1 || n_cols == crd::kRkcMaxStages + 2, nyl + 2 * halo,
      nxl + 2 * halo, [&](auto stim) {
        return crd::with_kinetics(kinetics, [&](auto kin) {
          using Rhs = ProfileRhs<decltype(kin)::value, T>;
          return crd::launch_rkc_chunk<Rhs, HaloGrid, T>(
              Rhs{k}, grid, plan, most, y, y_new, ss, work, h, fz, s,
              mu1_tab, ctab, s_cap, rtol, atol, stream, stim);
        });
      });
}

// crd::rkc_chunk_info of the kernel of `kinetics` in T
template <typename T>
int info(int kinetics, int* out) {
  if (!crd::valid_kinetics(kinetics))
    return static_cast<int>(cudaErrorInvalidValue);
  return crd::with_kinetics(kinetics, [&](auto kin) {
    return crd::rkc_chunk_info<ProfileRhs<decltype(kin)::value, T>, HaloGrid,
                               T>(out);
  });
}

}  // namespace

// amps, rows, cols, n_stim, n_cols and var1: the structured forcing;
// work: ten planes of the buffer's shape; (sum_tx, sum_ty): the partial
// sums' tiles, each dividing 32
#define CRD_FUSED_SHARD_RKC_ARGS                                             \
  const void *y, void *y_new, void *ss, void *work, const void *h,           \
      const void *fz, const void *amps, const void *rows,                    \
      const void *cols, int n_stim, int n_cols, int var1, const void *s,     \
      const void *mu1_tab, const void *ctab,                                 \
      int s_cap, const void *c0, const void *c1, const void *c2, int torus,  \
      const void *beta, int beta_field, const void *mask, int has_freeze,    \
      int kinetics, int nyl, int nxl, int halo, int valid_rows,              \
      int valid_cols, int sum_tx, int sum_ty, double rtol, double atol,      \
      void *stream
#define CRD_FUSED_SHARD_RKC_PASS                                             \
  y, y_new, ss, work, h, fz, amps, rows, cols, n_stim, n_cols, var1, s,      \
      mu1_tab, ctab, s_cap, c0, c1, c2, torus,                               \
      beta, beta_field, mask, has_freeze, kinetics, nyl, nxl, halo,          \
      valid_rows, valid_cols, sum_tx, sum_ty, rtol, atol, stream

extern "C" int crd_fused_shard_rkc_step_f32(CRD_FUSED_SHARD_RKC_ARGS) {
  return launch<float>(CRD_FUSED_SHARD_RKC_PASS);
}

extern "C" int crd_fused_shard_rkc_step_f64(CRD_FUSED_SHARD_RKC_ARGS) {
  return launch<double>(CRD_FUSED_SHARD_RKC_PASS);
}

extern "C" int crd_fused_shard_rkc_info(int f64, int kinetics, int* out) {
  return f64 ? info<double>(kinetics, out) : info<float>(kinetics, out);
}
