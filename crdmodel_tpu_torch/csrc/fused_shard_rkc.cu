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
// and one launch computes all s Chebyshev stages, y_new and one partial
// sum of squared WRMS-scaled errors per thread block over the PHYSICAL
// cells. The caller max-reduces the spectral-radius bound across the
// shards before s is chosen, so every shard runs the same s and the same
// table rows, and adds every shard's partials in a fixed order.
//
// The tile scheme is rkc_tile.cuh's one pass over s + 1 rings with the
// HaloGrid policy
// (rhs_common.cuh): the tile loads its s + 1 rings from the buffer, no index
// wraps, and the RHS indexes the shard's halo-padded constants. Mirror-pad
// cells of a mesh that does not divide the grid step like their sources
// and stay out of the error sum, as in K8 (fused_shard_step.cu). Only the
// block of y_new is written.
//
// What bounds it on an H100: as K2, the buffer read once and y_new's block
// written once whatever s; the halo recompute of s + 1 rings a tile and the
// barriers between stages bound a step long before device memory does.

#include <cuda_runtime.h>

#include "rhs_common.cuh"
#include "rkc_tile.cuh"

namespace {

using crd::HaloGrid;
using crd::ProfileRhs;

template <typename T>
int launch(const void* y, void* y_new, void* ss, const void* h,
           const void* fz, const void* s, const void* mu1_tab,
           const void* ctab, int s_cap, const void* c0, const void* c1,
           const void* c2, int torus, const void* beta, int beta_field,
           const void* mask, int has_freeze, int kinetics, int nyl, int nxl,
           int halo, int valid_rows, int valid_cols, int tile_x, int tile_y,
           double rtol, double atol, void* stream) {
  if (s_cap < 2 || s_cap > crd::kRkcMaxStages || halo < s_cap + 1
      || nyl < 1 || nxl < 1 || tile_x < 1 || tile_y < 1
      || !crd::valid_kinetics(kinetics) || valid_rows < 0
      || valid_rows > nyl || valid_cols < 0 || valid_cols > nxl)
    return static_cast<int>(cudaErrorInvalidValue);
  const crd::RhsConstants<T> k = {
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), torus, static_cast<const T*>(beta),
      beta_field, static_cast<const T*>(mask), has_freeze};
  const HaloGrid grid = {nyl, nxl, halo, valid_rows, valid_cols};
  if (kinetics == crd::kFhn)
    return crd::launch_rkc_tile<ProfileRhs<crd::kFhn, T>, HaloGrid, T>(
        {k}, grid, y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, nyl, nxl,
        tile_x, tile_y, rtol, atol, stream);
  if (kinetics == crd::kGoldbeter)
    return crd::launch_rkc_tile<ProfileRhs<crd::kGoldbeter, T>, HaloGrid, T>(
        {k}, grid, y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, nyl, nxl,
        tile_x, tile_y, rtol, atol, stream);
  return crd::launch_rkc_tile<ProfileRhs<crd::kAlievPanfilov, T>, HaloGrid,
                              T>(
      {k}, grid, y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, nyl, nxl,
      tile_x, tile_y, rtol, atol, stream);
}

}  // namespace

#define CRD_FUSED_SHARD_RKC_ARGS                                             \
  const void *y, void *y_new, void *ss, const void *h, const void *fz,      \
      const void *s, const void *mu1_tab, const void *ctab, int s_cap,      \
      const void *c0, const void *c1, const void *c2, int torus,            \
      const void *beta, int beta_field, const void *mask, int has_freeze,   \
      int kinetics, int nyl, int nxl, int halo, int valid_rows,             \
      int valid_cols, int tile_x, int tile_y, double rtol, double atol,     \
      void *stream
#define CRD_FUSED_SHARD_RKC_PASS                                             \
  y, y_new, ss, h, fz, s, mu1_tab, ctab, s_cap, c0, c1, c2, torus, beta,    \
      beta_field, mask, has_freeze, kinetics, nyl, nxl, halo, valid_rows,   \
      valid_cols, tile_x, tile_y, rtol, atol, stream

extern "C" int crd_fused_shard_rkc_step_f32(CRD_FUSED_SHARD_RKC_ARGS) {
  return launch<float>(CRD_FUSED_SHARD_RKC_PASS);
}

extern "C" int crd_fused_shard_rkc_step_f64(CRD_FUSED_SHARD_RKC_ARGS) {
  return launch<double>(CRD_FUSED_SHARD_RKC_PASS);
}
